"""``launches_per_rhs``: the port's own kernel launches a right-hand side
(those its ``ops`` wrappers count in ``ops.LAUNCHES``, with a replayed
graph's launches added per replay; not aten's or cuBLAS's): the root
``gmres.solve`` spans' ``launches`` summed over the traced requests and
divided by their right-hand sides.  Read from ``repro_torch.tracing``'s
rows; ``None`` for a program without them, unless they hold exactly one
root ``gmres.solve`` of the request's right-hand sides per traced
request."""


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
    _, roots = got
    if any("launches" not in r["attrs"] for r in roots):
        return None
    return (sum(r["attrs"]["launches"] for r in roots)
            / sum(q.p for q in run.traced))
