"""``mgs_fired_share``: live steps at which MGS's second pass ran
(``GmresResult.fired``) over live steps, over the window's requests."""


def read(run):
    live = sum(sum(r.live) for r in run.requests)
    fired = sum(sum(map(bool, f)) for r in run.requests for f in r.fired)
    return 100.0 * fired / live if live else None
