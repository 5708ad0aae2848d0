"""``peak_gib``: ``torch.cuda.max_memory_allocated()`` from before the
program's first allocation to the window's end, less the harness's own
buffers allocated before it (its operator copy and the sample's ``b`` and
``x``); a request's right-hand sides and their temporaries (about four
vectors a right-hand side) stay in it."""


def read(run):
    if run.program_peak_bytes is None:
        return None
    return run.program_peak_bytes / 2 ** 30
