"""``setup_s``: process start to the window's start (imports, operator,
library build or load, the warm-up solve with its graph capture)."""


def read(run):
    return run.setup_s
