"""``ms_per_rhs``: the window's wall over the right-hand sides it solved to
target (host clock; the window runs from its first request's right-hand
side to its last request's solution, synchronised)."""


def read(run):
    solved = sum(c for r in run.requests for c in r.converged)
    return run.window_s * 1e3 / solved if solved else None
