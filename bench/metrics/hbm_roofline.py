"""``hbm_roofline``: the least bytes of the traced requests' live work
(basis, operator and vectors: ``bench.counts.live_work_bytes``) at the
card's memory rate, over the traced window's wall.  It bounds the whole
solve, whichever kernels do the work."""
from bench import counts


def read(run):
    rate = counts.hbm_bytes_per_s(run.device)
    t = run.trace
    if rate is None or t is None or t.busy_s <= 0:
        return None
    need = sum(counts.live_work_bytes(r, run.n, run.nnz, run.fmt,
                                      block=run.block) for r in run.traced)
    return 100.0 * need / rate / t.window_s
