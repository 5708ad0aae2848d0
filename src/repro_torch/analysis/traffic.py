"""Stage 3: the recorded collective census, and the basis-reads audit.

The port's figures rest on hand-kept byte accounting: ``exchange_bytes``,
``gather_bytes``, ``reduce_bytes`` and ``halo_bytes`` for the wire,
``cycle_wire_bytes`` for a sharded cycle, ``GmresResult.bytes_read`` and
``op_reads`` for the basis and the operator.  There is no program to walk
before it runs, so this stage records what runs
(:class:`repro_torch.dist.census.Census`) and prices each recorded call by
the JAX package's rules (``repro/analysis/traffic.py``), per device:

  * ``all_reduce`` ships its operand once (:func:`reduce_bytes`): a
    one-value operand is a norm, a longer one the orthogonalization dots;
  * ``all_gather_into_tensor`` forwards every other rank's chunk: ``(P -
    1) x`` its operand (:func:`gather_bytes`);
  * an exchange (``batch_isend_irecv`` of one permutation) ships its payload
    across one link once (:func:`exchange_bytes`), whichever ranks its
    pairs name; a coded payload is its codes and exponents, the buffer as
    it travels;
  * a reduction over the peer gather (``peer_gather``, MGS's second pass in
    a captured cycle's IF node) is priced as the reference prices the
    reduction of its values (:func:`reduce_bytes`, recorded so by the
    census): a norm or the dots, as an ``all_reduce``.

and holds the model to exact equality -- both sides count the same
integers.  Every rank's recorded sequence must be the same (the group
collectives would hang otherwise), every exchange's sends and receives must
pair up along its permutation, every permutation must be a partial
injection and the 3-D schedule's rounds disjoint, and every call of a
solve must run on the solve's group.

Audits:

  * **matvec wire**: one partitioned matvec of each mode (rows; halo and
    block3d, plain and coded), priced against
    ``OperatorPlan.matvec_wire_bytes``;
  * **the solve census**: a warmed rows-mode sharded solve (CGS2, ``m``,
    ``k`` full cycles) split into the ``"cycle"`` bucket (calls inside
    ``_device_cycle``) and the ``"solve"`` bucket, against
    ``solver/sharded.py::cycle_wire_bytes``;
  * **basis reads** (:func:`audit_reads`, no group needed): a
    fixed-trajectory solve whose ``bytes_read`` must equal ``cycles x
    _cycle_row_reads(m, 2, 0) x row_bytes`` under CGS2, the row bytes read
    off the real store tensors, and whose ``op_reads`` must equal ``1 +
    cycles x (m + 2)``; also through ``gmres_block`` (one shared block row
    serves all ``p`` right-hand sides, each result carrying a ``1/p``
    share).  Under MGS each cycle is ``_cycle_row_reads(m, 1, extra) x
    row_bytes``, ``extra`` the rows of the steps whose ``fired`` slot the
    cycle set (``GmresResult.fired``: the steps where the captured cycle's
    IF node ran the second sweep).

An IF node's body holds no NCCL call: the census checks every captured
body's recorded calls (``raw-collective``), since CUDA refuses them there
and only the peer gather may carry the second pass's reductions.
"""
from __future__ import annotations

import contextlib
import importlib
import math
from collections import Counter

import torch

from repro_torch.analysis.report import Finding
from repro_torch.dist.collectives import (
    gather_bytes,
    perm_defect,
    reduce_bytes,
    rounds_defect,
)

__all__ = ["audit_reads", "census_world", "check_census", "price",
           "price_calls", "run_local_traffic", "solve_census_model",
           "world_rank"]


def _finding(audit: str, rule: str, message: str) -> Finding:
    return Finding(path=f"traffic:{audit}", line=0, rule=rule,
                   message=message)


# ---------------------------------------------------------------------------
# Pricing
# ---------------------------------------------------------------------------


class Unpriceable(Exception):
    """A recorded call the wire model has no rule for (itself a finding)."""


def _numel(shape) -> int:
    return math.prod(shape) if shape else 1


def price(call) -> tuple[str, int]:
    """``(category, per-device wire bytes)`` of one recorded call."""
    if call.name in ("all_reduce", "peer_gather"):
        return ("norms" if _numel(call.shape) == 1 else "dots"), call.nbytes
    if call.name == "all_gather_into_tensor":
        return "matvec", (len(call.group) - 1) * call.nbytes
    if call.name == "batch_isend_irecv" and call.perm is not None:
        return "matvec", call.nbytes
    raise Unpriceable(f"no wire-pricing rule for {call.name} "
                      f"{call.shape} {call.dtype}")


def price_calls(calls) -> dict:
    """Per-device wire bytes of ``calls``: ``{"solve": Counter, "cycle":
    Counter}`` keyed by ``dots``/``norms``/``matvec``."""
    acc = {"solve": Counter(), "cycle": Counter()}
    for c in calls:
        cat, nbytes = price(c)
        acc[c.bucket][cat] += nbytes
    return acc


# ---------------------------------------------------------------------------
# The checks, over every rank's recorded calls
# ---------------------------------------------------------------------------


def _check_uniform(label, per_rank, findings) -> bool:
    """The same signature sequence on every rank (``nonuniform-collective``)."""
    ref = [c.signature() for c in per_rank[0]]
    ok = True
    for r, calls in enumerate(per_rank[1:], start=1):
        sig = [c.signature() for c in calls]
        if sig == ref:
            continue
        ok = False
        i = next((i for i, (a, b) in enumerate(zip(ref, sig)) if a != b),
                 min(len(ref), len(sig)))
        findings.append(_finding(label, "nonuniform-collective", (
            f"rank {r} issued {len(sig)} collectives, rank 0 {len(ref)}; "
            f"they first differ at call {i}: rank 0 "
            f"{ref[i] if i < len(ref) else 'nothing'}, rank {r} "
            f"{sig[i] if i < len(sig) else 'nothing'} -- the group would "
            "hang")))
    return ok


def _check_exchanges(label, per_rank, findings) -> None:
    """Every exchange's permutation well-formed and its sends and receives
    paired along it, with the payload's shape at both ends."""
    P = len(per_rank)
    for i, call in enumerate(per_rank[0]):
        if call.name != "batch_isend_irecv" or call.perm is None:
            continue
        defect = perm_defect(call.perm, len(call.group))
        if defect is not None:
            findings.append(_finding(label, "bad-permutation", (
                f"exchange {i}: permutation {call.perm} is malformed: "
                f"{defect}")))
            continue
        for r in range(P):
            mine = per_rank[r][i]
            want = sorted(
                [("send", d) for s, d in call.perm if s == r]
                + [("recv", s) for s, d in call.perm if d == r])
            got = sorted((op[0], op[1]) for op in mine.ops)
            shapes = {(op[2], op[3]) for op in mine.ops}
            if got != want or shapes - {(mine.shape, mine.dtype)}:
                findings.append(_finding(label, "nonuniform-collective", (
                    f"exchange {i} on rank {r}: issued {got} of "
                    f"{sorted(shapes)} where the permutation {call.perm} "
                    f"asks {want} of {mine.shape} {mine.dtype} -- an "
                    "unmatched send or receive hangs its pair")))


def _check_groups(label, per_rank, group, findings) -> None:
    for r, calls in enumerate(per_rank):
        for i, c in enumerate(calls):
            if c.group != group:
                findings.append(_finding(label, "axis-mismatch", (
                    f"rank {r} call {i} ({c.name}) ran on ranks {c.group}, "
                    f"not on the solve's group {group}")))
                return


def _check_bytes(label, priced, want, what, findings) -> None:
    for bucket in ("solve", "cycle"):
        got = dict(priced[bucket])
        wanted = want.get(bucket, {})
        for cat in sorted(set(wanted) | set(got)):
            g, e = got.get(cat, 0), wanted.get(cat, 0)
            if g != e:
                findings.append(_finding(label, "wire-model", (
                    f"per-{bucket} {cat} traffic: the recorded collectives "
                    f"move {g} B/device but the model prices {e} B "
                    f"({what})")))


def check_census(label, per_rank, group, want, what) -> tuple[list, dict]:
    """Every check on one recorded run: ``per_rank[r]`` rank ``r``'s calls,
    ``group`` the run's group ranks, ``want`` the modelled ``{bucket:
    {category: bytes}}``.  Returns ``(findings, rank 0's priced bytes)``."""
    findings: list[Finding] = []
    uniform = _check_uniform(label, per_rank, findings)
    if uniform:
        _check_exchanges(label, per_rank, findings)
    _check_groups(label, per_rank, group, findings)
    try:
        priced = price_calls(per_rank[0])
    except Unpriceable as exc:
        findings.append(_finding(label, "wire-model", str(exc)))
        return findings, {}
    _check_bytes(label, priced, want, what, findings)
    return findings, {b: dict(v) for b, v in priced.items()}


# ---------------------------------------------------------------------------
# The census on every rank of a live group
# ---------------------------------------------------------------------------


def _problems(device, rows_A=None, halo_A=None):
    from repro_torch.sparse import make_problem

    if rows_A is None:
        rows_A, _ = make_problem("synth:atmosmod", 256, device=device)
    if halo_A is None:
        halo_A, _ = make_problem("synth:stencil27", 512, device=device)
    return rows_A, halo_A


#: the matvec audits: (label, operator, mode, coded halo)
MATVEC_CASES = (("rows", "rows", "rows", False),
                ("halo", "halo", "halo", False),
                ("halo+frsz2", "halo", "halo", True),
                ("block3d", "halo", "block3d", False),
                ("block3d+frsz2", "halo", "block3d", True))


def census_world(rank: int, device, *, m: int = 8, k: int = 2, rows_A=None,
                 halo_A=None, info: dict | None = None,
                 ortho: str = "cgs2", eta: float | None = None
                 ) -> list[Finding]:
    """The census on this rank of the live default group (the sharded
    solve's); every rank must call it.  Records one partitioned matvec of
    each :data:`MATVEC_CASES` mode and a warmed rows-mode sharded solve
    (float64, plain transport, ``ortho``, ``k`` cycles of ``m``), gathers
    every rank's calls and checks them (the same findings on every rank).
    ``rows_A``/``halo_A``: the operators (default ``synth:atmosmod`` n 256
    and ``synth:stencil27`` n 512, as the JAX package's audit).

    Under MGS (at ``eta``, or the solver's default) the model is the
    reference's: the second pass's reductions at the fired steps only
    (``GmresResult.fired``), as a captured cycle's IF node (the card)
    issues them over the peer kernel.  A cycle that runs the pass at every
    step -- an eager one (gloo on the CPU), or a branch-free one
    (``second_pass == "select"``: cards without peer access) -- ships more
    than the reference wherever a step did not fire, and the census reports
    it (``wire-model``).  The captured bodies must hold no NCCL call
    (:func:`_check_bodies`).
    """
    import torch.distributed as dist

    from repro_torch.analysis.traceaudit import fixed_trajectory
    from repro_torch.dist import collectives as C
    from repro_torch.dist.census import Census
    from repro_torch.solver import gmres
    from repro_torch.sparse import partition_matvec, rhs_for
    from repro_torch.sparse.plan import plan_operator

    info = {} if info is None else info
    P = dist.get_world_size()
    ranks = tuple(range(P))
    rows_A, halo_A = _problems(device, rows_A, halo_A)
    ops = {"rows": rows_A, "halo": halo_A}
    gen = torch.Generator().manual_seed(rank)

    recorded = {}
    plans = {}
    for label, op, mode, comp in MATVEC_CASES:
        plan = plans[label] = plan_operator(ops[op], P, reorder="none",
                                            matvec_mode=mode)
        mv = partition_matvec(plan=plan, rank=rank, compressed_halo=comp,
                              device=device)
        x = torch.randn(plan.n_local, generator=gen,
                        dtype=torch.float64).to(device)
        with Census() as c:
            mv(x)
        recorded[label] = c.calls

    b, _ = rhs_for(rows_A, device=device)
    kw = dict(fixed_trajectory(m, k), storage="float64", shard=P,
              shard_transport="plain", shard_matvec="rows", reorder="none",
              ortho=ortho)
    if eta is not None:
        kw["eta"] = eta
    gmres(rows_A, b, **kw)                    # warm: capture on the card
    with Census() as c:
        res = gmres(rows_A, b, **kw)
    recorded["solve"] = c.calls
    per_rank = C.gather_objects(recorded)

    info["calls"] = {label: [r[label] for r in per_rank]
                     for label, *_ in MATVEC_CASES}
    findings: list[Finding] = []
    block = plans["block3d"].block
    if block is not None:
        defect = rounds_defect(block.rounds, P)
        if defect is not None:
            findings.append(_finding("rounds[block3d]", "bad-permutation",
                                     f"the 3-D exchange schedule: {defect}"))
    for label, _, mode, comp in MATVEC_CASES:
        plan = plans[label]
        want = {"solve": {"matvec": plan.matvec_wire_bytes(
            compressed=comp, dtype=torch.float64)}}
        f, priced = check_census(
            f"matvec[{label}]", [r[label] for r in per_rank], ranks, want,
            f"plan.matvec_wire_bytes(compressed={comp}), {plan.matvec_mode}"
            f", P={P}")
        findings += f
        info[f"matvec[{label}]"] = dict(priced=priced, model=want)

    fired = None if ortho == "cgs2" else [int(c.sum()) for c in res.fired]
    findings += _check_solve(per_rank, ranks, plans["rows"], res, m, k, P,
                             info, fired)
    return findings + _check_bodies()


def _check_bodies() -> list[Finding]:
    """No collective but the peer gather inside any captured IF body (of
    the cycles in the graph cache): CUDA refuses NCCL's there."""
    from repro_torch.solver.gmres import _GRAPHS

    findings = []
    for cyc in _GRAPHS.values():
        for j, body in enumerate(cyc.bodies):
            bad = sorted({c.name for c in body.calls} - {"peer_gather"})
            if bad:
                findings.append(_finding(
                    "census[if-bodies]", "raw-collective",
                    f"the IF node of step {j} of a captured cycle holds "
                    f"{bad}: only the peer gather may carry the second "
                    "pass's reductions inside a conditional node"))
    return findings


def _check_solve(per_rank, ranks, plan, res, m, k, P, info, fired=None):
    """The solve census against :func:`solve_census_model`."""
    label = "census[rows]" if fired is None else "census[rows, mgs]"
    if res.restarts != k or res.iterations != k * m:
        return [_finding(label, "wire-model", (
            f"fixed-trajectory assumption broke: {res.restarts} restarts / "
            f"{res.iterations} iterations, expected {k} / {k * m}"))]
    want = solve_census_model(plan, m, k, fired)
    how = ("CGS2" if fired is None else
           f"MGS, second pass at the fired steps {fired} a cycle (route "
           f"{res.second_pass})")
    findings, priced = check_census(
        label, [r["solve"] for r in per_rank], ranks, want,
        f"cycle_wire_bytes: {how}, m={m}, j_stop={m}, {k} cycles, P={P}")
    info[label] = dict(priced=priced, model=want, fired=fired,
                       second_pass=res.second_pass,
                       calls=len(per_rank[0]["solve"]),
                       names=dict(Counter(c.name
                                          for c in per_rank[0]["solve"])))
    return findings


def solve_census_model(plan, m: int, k: int, fired=None) -> dict:
    """The modelled per-device wire bytes of a rows-mode plain solve of
    ``k`` full cycles, by bucket: CGS2 (``fired`` None), or MGS with
    ``fired[c]`` re-orthogonalized steps in cycle ``c``.

    ``cycle_wire_bytes`` prices a cycle with its restart terms: the restart
    residual and the explicit RRN after the update (2 norms, 2 exact
    matvecs).  The port issues those in the restart loop, outside
    ``_device_cycle``: they are the ``"solve"`` bucket's, beside ``||b||``
    (one norm a solve) and the all-gather that assembles ``x`` (one rows
    transport a solve)."""
    from repro_torch.solver.sharded import cycle_wire_bytes

    w = plan.matvec_wire_bytes(dtype=torch.float64)
    r1 = reduce_bytes(1, compressed=False)
    cycles = [cycle_wire_bytes(m, j_stop=m, reorth=f,
                               passes=2 if fired is None else 1,
                               dots_compressed=False, norms_compressed=False,
                               inner_mv_bytes=w, residual_mv_bytes=w)
              for f in ([0] * k if fired is None else fired)]
    return {
        "cycle": {"dots": sum(c["dots"] for c in cycles),
                  "norms": sum(c["norms"] - 2 * r1 for c in cycles),
                  "matvec": sum(c["matvec"] - 2 * w for c in cycles)},
        "solve": {"norms": r1 + k * 2 * r1,
                  "matvec": k * 2 * w + gather_bytes(plan.n_local,
                                                     plan.n_shards)},
    }


# ---------------------------------------------------------------------------
# Basis reads on a fixed trajectory (no group needed)
# ---------------------------------------------------------------------------


def _nbytes(store) -> int:
    if isinstance(store, dict):
        return sum(_nbytes(v) for v in store.values())
    return store.numel() * store.element_size()


@contextlib.contextmanager
def _stores(module: str, fn: str):
    """The basis stores ``module.fn`` (a cycle) is called with."""
    mod = importlib.import_module(module)
    orig = getattr(mod, fn)
    seen = []

    def watched(bmv, acc, store, *args, **kw):
        seen.append((acc, store))
        return orig(bmv, acc, store, *args, **kw)

    setattr(mod, fn, watched)
    try:
        yield seen
    finally:
        setattr(mod, fn, orig)


def audit_reads(A, b, *, storage: str, m: int = 6, k: int = 3,
                p: int | None = None, info: dict | None = None,
                ortho: str = "cgs2", eta: float | None = None,
                shard: int | None = None) -> list[Finding]:
    """The fixed-trajectory reads audit of one storage format: the device
    driver, or ``gmres_block`` with ``p`` right-hand sides; ``ortho`` CGS2
    (two sweeps a step) or MGS (one, plus the fired ones) at ``eta`` (the
    solver's default if None).  ``shard``: the scalar solve sharded over
    the live group of that many ranks (every rank calls it; the rows are
    this rank's chunk)."""
    from repro_torch.analysis.traceaudit import block_rhs, fixed_trajectory
    from repro_torch.solver import gmres
    from repro_torch.solver.block import gmres_block
    from repro_torch.solver.gmres import _cycle_row_reads

    info = {} if info is None else info
    kw = dict(fixed_trajectory(m, k), storage=storage, ortho=ortho)
    if eta is not None:
        kw["eta"] = eta
    tag = "" if ortho == "cgs2" else f", {ortho}"
    if shard is not None:
        kw["shard"] = shard
        tag += f", shard={shard}"
    if p is None:
        label = f"reads[{storage}{tag}]"
        with _stores("repro_torch.solver.gmres", "_device_cycle") as seen:
            res = [gmres(A, b, **kw)]
    else:
        label = f"block-reads[{storage}, p={p}{tag}]"
        with _stores("repro_torch.solver.block", "_block_cycle") as seen:
            res = gmres_block(A, block_rhs(b, p), **kw)
    share = 1 if p is None else p
    if not seen:
        return [_finding(label, "reads-model",
                         "the solve ran no cycle: nothing to hold")]
    acc, store = seen[-1]
    row_bytes = _nbytes(store) / acc.m
    model_row = acc.nbytes() / acc.m
    r0 = res[0]
    info[label] = dict(row_bytes=row_bytes, bytes_read=r0.bytes_read * share,
                       op_reads=r0.op_reads * share, restarts=r0.restarts,
                       iterations=[r.iterations for r in res])
    if row_bytes != model_row:
        return [_finding(label, "reads-model", (
            f"the store tensors hold {row_bytes} B a basis row but "
            f"{type(acc.fmt).__name__}.nbytes() models {model_row} B -- the "
            "storage accounting does not match the buffers"))]
    if r0.restarts != k or any(r.iterations != k * m for r in res):
        return [_finding(label, "reads-model", (
            f"fixed-trajectory assumption broke: {r0.restarts} restarts / "
            f"iterations {[r.iterations for r in res]}, expected {k} / "
            f"{k * m} -- the audit's premises no longer hold, fix the "
            "audit"))]
    findings = []
    if ortho == "cgs2":
        rows = k * _cycle_row_reads(m, 2, 0)
        how = f"{k} cycles x _cycle_row_reads({m}, passes=2)"
    else:
        if r0.fired.shape != (k, m):
            return [_finding(label, "reads-model", (
                f"fired slots of shape {r0.fired.shape}, expected ({k}, "
                f"{m}): one a step of each cycle"))]
        extras = [int(sum(j + 1 for j in range(m) if c[j]))
                  for c in r0.fired]
        rows = sum(_cycle_row_reads(m, 1, e) for e in extras)
        how = (f"sum over cycles of _cycle_row_reads({m}, passes=1, extra)"
               f", extra {extras} from the fired slots")
        info[label]["fired_steps"] = [int(c.sum()) for c in r0.fired]
        unfired = k * _cycle_row_reads(m, 1, m * (m + 1) // 2) - rows
        if r0.second_pass == "select" and unfired:
            findings.append(_finding(label, "reads-model", (
                f"the second pass runs branch-free (route select: the "
                f"group's cards lack peer access) and sweeps {unfired} basis "
                "rows at the steps that did not fire, which bytes_read, as "
                "the reference's, does not count")))
    expect = float(rows * row_bytes)
    expect_reads = 1.0 + k * (m + 2)
    for i, r in enumerate(res):
        if r.bytes_read != expect / share:
            findings.append(_finding(label, "reads-model", (
                f"result {i}: bytes_read reports {r.bytes_read} B but "
                f"{how} x {row_bytes} B/row (from the store tensors) / "
                f"{share} = {expect / share} B")))
        if r.op_reads != expect_reads / share:
            findings.append(_finding(label, "reads-model", (
                f"result {i}: op_reads reports {r.op_reads} but the "
                f"trajectory applies the operator 1 + {k} x ({m} + 2) = "
                f"{expect_reads} times (/ {share})")))
    return findings


def run_local_traffic(device="cuda", info: dict | None = None
                      ) -> list[Finding]:
    """The reads audit at the JAX package's sizes (``synth:atmosmod`` n
    180; m 6, k 3; the block driver at p 3, m 4, k 2), CGS2 as the JAX
    package's, then MGS (the port's default orthogonalizer) on each
    driver."""
    from repro_torch.analysis.traceaudit import problem

    A, b, _ = problem(180, device)
    findings = []
    for ortho in ("cgs2", "mgs"):
        for storage in ("float64", "frsz2_32"):
            findings += audit_reads(A, b, storage=storage, m=6, k=3,
                                    info=info, ortho=ortho)
        for storage in ("float64", "frsz2_32"):
            findings += audit_reads(A, b, storage=storage, m=4, k=2, p=3,
                                    info=info, ortho=ortho)
    return findings


# ---------------------------------------------------------------------------
# The sharded legs of the CLI: one spawned world
# ---------------------------------------------------------------------------


def world_rank(rank: int, device, stages: tuple, info: dict | None = None
               ) -> list[Finding]:
    """One rank of the CLI's world (``repro_torch.dist.spawn``): the
    sharded recapture audit (``"audit"`` in ``stages``) and the census
    (``"spmd"``), on the default group.  Every rank's findings are gathered
    and returned, deduplicated, on every rank."""
    import torch.distributed as dist

    from repro_torch.analysis.traceaudit import (
        audit_sharded_recapture,
        problem,
    )
    from repro_torch.dist.collectives import gather_objects

    info = {} if info is None else info
    P = dist.get_world_size()
    findings: list[Finding] = []
    if "audit" in stages:
        A, b, _ = problem(256, device)
        findings += audit_sharded_recapture(A, b, shard=P, info=info)
    if "spmd" in stages:
        findings += census_world(rank, device, info=info)
    seen, out = set(), []
    for f in (f for fs in gather_objects(findings) for f in fs):
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out
