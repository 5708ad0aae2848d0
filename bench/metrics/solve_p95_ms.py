"""``solve_p95_ms``: the 95th percentile of request latency (host clock,
from handing ``b`` over to ``x`` back and synchronised) over every request
of the window; the count is printed on standard error."""
import statistics


def read(run):
    lat = [r.latency_s * 1e3 for r in run.requests]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
