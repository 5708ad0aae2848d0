"""``steps_run_per_rhs``: the Arnoldi steps the cycles ran a right-hand
side: the program's ``gmres.replay`` spans' ``steps_run`` (a replayed
unsharded scalar cycle runs no step after its last live one; a cycle that
runs its dead steps too counts all ``m``), summed over the traced requests
and divided by their right-hand sides.  Read from ``repro_torch.tracing``'s
rows; ``None`` for a program without them, unless they hold exactly one
root ``gmres.solve`` of the request's right-hand sides per traced request,
and where a replay has no ``steps_run``."""


def _solves(run):
    """The tracer's rows and the ids of the traced requests' solves, or
    ``None``."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    rows = tracing.rows()
    roots = [r for r in rows if r["name"] == "gmres.solve"
             and r["parent"] is None and r["end_ns"] is not None]
    if (not run.traced or tracing.counters().get("rows_dropped")
            or [r["attrs"].get("p") for r in roots]
            != [q.p for q in run.traced]):
        return None
    return rows, roots


def read(run):
    got = _solves(run)
    if got is None:
        return None
    rows, roots = got
    ids = {r["solve"] for r in roots}
    steps = [r["attrs"].get("steps_run") for r in rows
             if r["name"] == "gmres.replay" and r["solve"] in ids]
    if not steps or None in steps:
        return None
    return sum(steps) / sum(q.p for q in run.traced)
