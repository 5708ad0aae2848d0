"""``live_step_share``: live steps over the steps the captured cycles ran
(``m`` a cycle), over the window's requests.  A cycle's live steps end at
the first step whose estimate met the target; the benchmark splits each
solve's estimate history into its cycles (``bench.counts.live_steps``)."""


def read(run):
    live = sum(sum(r.live) for r in run.requests)
    ran = sum(len(r.live) * r.m for r in run.requests)
    return 100.0 * live / ran if ran else None
