"""``iters_per_rhs``: inner iterations a right-hand side
(``GmresResult.iterations``) over the window's requests."""


def read(run):
    its = [i for r in run.requests for i in r.iterations]
    return sum(its) / len(its) if its else None
