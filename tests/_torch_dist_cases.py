"""The multi-rank halves of ``tests/test_torch_sharded.py`` and
``tests/test_torch_collectives.py``: the cases both packages run, and the
port's rank functions (gloo on the CPU, no JAX).

A test runs ``python -c "import _torch_dist_cases as c; c.main()" <which>
<out.pkl>`` with ``src`` and ``tests`` on ``PYTHONPATH``: one world of
:data:`WORLD` ranks a test module, spawned by ``repro_torch.dist.spawn``
under a deadline, every case inside it; rank 0's results are pickled to
``out.pkl``.  The JAX halves import only the case lists from here.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: ranks of the spawned world (the reference tests emulate 8 devices)
WORLD = 8
#: seconds a world may take before the test fails: three times the
#: slowest world measured, 140.7 s (the sharded module's world in a run of
#: that module alone on a shared 8-core host; 111.0 s alone on an idle
#: one, 112.0 and 121.5 s under ``pytest -n 6 --dist loadfile``; the
#: collectives module's 12-20 s).  Most of a world's wall is gloo's
#: all-reduce at 8 ranks (3.6 of a 4.7 s solve, 307 calls), whose latency
#: grows with the host's load: 2.8 ms idle, 17 ms beside 48 busy threads,
#: where a solve took 1.9 times as long.  Under a full test run on a
#: loaded host the world outlived the former 300 s (3 x 100 s, measured
#: before the float64 switch solves, 31 s, joined the world)
DEADLINE_S = 420.0
#: seconds each subprocess of a test module may take (a test run has a
#: hard clock): the world's deadline plus the ranks' start and teardown
SUBPROCESS_S = 480

#: sharded solves at P = 8, m = 20 (``synth:atmosmod`` n = 512 as in
#: ``tests/test_sharded_driver.py``; ``mode`` is ``shard_matvec``)
SOLVE_CASES = [
    dict(problem="synth:atmosmod", n=512, storage="frsz2_32",
         transport=t, mode="auto") for t in
    ("plain", "compressed", "compressed+norms")
] + [
    dict(problem="synth:atmosmod", n=512, storage="float64",
         transport="plain", mode="auto"),
    dict(problem="synth:atmosmod", n=512, storage="frsz2_32",
         transport="compressed", mode="halo"),
    dict(problem="synth:atmosmod", n=512, storage="float64",
         transport="plain", mode="rows"),
    dict(problem="synth:atmosmod", n=512, storage="float64",
         transport="plain", mode="replicated"),
    dict(problem="synth:atmosmod", n=512, storage="mixed:2:frsz2_32",
         transport="compressed", mode="auto"),
    # padding: 1001 rows over 8 ranks (halo), and a 9^3 grid in 5^3 boxes
    # (block3d: pad slots inside the chunks)
    dict(problem="synth:lung", n=1001, storage="frsz2_32",
         transport="compressed", mode="auto"),
    dict(problem="synth:atmosmod", n=729, storage="frsz2_32",
         transport="compressed", mode="auto"),
    # batched: right-hand sides one by one (vmap) or in one block space
    dict(problem="synth:atmosmod", n=512, storage="frsz2_32",
         transport="compressed", mode="auto", method="vmap", k=2),
    dict(problem="synth:atmosmod", n=512, storage="frsz2_32",
         transport="plain", mode="auto", method="block", k=3),
    dict(problem="synth:atmosmod", n=512, storage="frsz2_32",
         transport="compressed", mode="halo", method="block", k=3),
    # operator planning: RCM unlocks the halo matvec of an unstructured
    # operator (reorder="auto"); Jacobi's shard_local
    dict(problem="synth:unstructured", n=512, storage="frsz2_32",
         transport="plain", mode="auto", reorder="auto"),
    dict(problem="synth:varcoef", n=512, storage="frsz2_32",
         transport="compressed", mode="halo", precond="jacobi"),
]
M = 20
MAX_ITERS = 2000

#: the coded transport's two halves switched one at a time (coded dots,
#: coded halo strips), float64 at P = 8 on ``synth:atmosmod`` n = 8000,
#: m = 100, halo matvec: the size at which a float64 solve pays for its
#: coded halo strips in both packages
SWITCHES = {"plain": (False, False), "dots": (True, False),
            "halo": (False, True), "both": (True, True)}
SWITCH_N, SWITCH_M = 8000, 100


def case_id(c: dict) -> str:
    parts = [c["problem"].split(":")[1], str(c["n"]), c["storage"],
             c["transport"], c["mode"]]
    for k in ("method", "reorder", "precond"):
        if k in c:
            parts.append(str(c[k]))
    return "-".join(parts)


def rhs(n: int) -> np.ndarray:
    """The right-hand side both packages solve: seeded numpy normals."""
    return np.random.default_rng(n).standard_normal(n)


def batch_rhs(b: np.ndarray, k: int) -> np.ndarray:
    """k right-hand sides: ``b`` and k-1 variants (the CLIs' ``_batch_rhs``)."""
    t = np.arange(b.shape[0], dtype=b.dtype)
    return np.stack([b] + [b * (1.0 + 0.1 * i) + 0.05 * i * np.sin(t * (i + 1))
                           for i in range(1, k)])


#: collectives: group sizes and halo strip schedules (n_local = 64: hop 1
#: only, and two hops, the first a whole chunk)
GROUPS = (2, 4, 8)
N_LOCAL = 64
STRIPS = ((5,), (64, 17))
PSUM_SIZES = (1, 101, 300)
MATVEC_MODES = ("halo", "rows", "replicated", "block3d")


def collective_inputs(P: int, n_pad3: int) -> dict:
    """The seeded inputs of the collectives' cases for a group of ``P``
    (``n_pad3``: the padded length of the block layout at ``P``)."""
    rng = np.random.default_rng(P)
    inp = dict(x=rng.standard_normal(P * N_LOCAL),
               X=rng.standard_normal((3, P * N_LOCAL)),
               xm=rng.standard_normal(512))
    for k in PSUM_SIZES:
        # a spread of scales, so the wire blocks' exponents differ
        inp[("v", k)] = (rng.standard_normal((P, k))
                         * 2.0 ** rng.integers(-20, 20, size=(P, k)))
    inp["tree"] = {"a": rng.standard_normal((P, 7)),
                   "b": rng.standard_normal((P, 2, 65))}
    inp["x3"] = rng.standard_normal(n_pad3)      # last: the rest ignore it
    return inp


def result_row(r) -> dict:
    """A GmresResult of either package as plain numbers and arrays."""
    return dict(iterations=int(r.iterations), restarts=int(r.restarts),
                rrn=float(r.rrn), converged=bool(r.converged),
                stagnated=bool(r.stagnated), bytes_read=float(r.bytes_read),
                op_reads=float(r.op_reads),
                restart_rrns=np.asarray(r.restart_rrns, dtype=np.float64),
                x=np.asarray(r.x, dtype=np.float64))


# ---------------------------------------------------------------------------
# The test modules' side: the worlds' subprocesses
# ---------------------------------------------------------------------------


def start(args, env_extra=None):
    """``python <args>`` from the repo root with ``src`` and ``tests``
    importable, in a session of its own (so that :func:`finish` can stop
    it with every rank it spawned)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), HERE,
                                         ROOT])
    env.update(env_extra or {})
    return subprocess.Popen([sys.executable, *args], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def finish(proc, what):
    """Wait for ``proc`` under :data:`SUBPROCESS_S`; fail the test if it
    expires or fails.  Its process group (the ranks it spawned) is killed
    on every path, so nothing it started outlives the test."""
    import pytest

    try:
        _, err = proc.communicate(timeout=SUBPROCESS_S)
    except subprocess.TimeoutExpired:
        _kill(proc)
        _, err = proc.communicate()
        pytest.fail(f"{what} did not finish within {SUBPROCESS_S} s:\n"
                    f"{err[-4000:]}")
    finally:
        _kill(proc)
    if proc.returncode != 0:
        pytest.fail(f"{what} failed:\n{err[-4000:]}")


def _kill(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def run_worlds(d, steps, once=False):
    """Run ``steps`` (``(what, args, env_extra)``) one after another, each
    to its end, under the run's world lock, and write their wall times to
    ``d / "walls.json"`` as each ends (a step that fails too, so that a
    failed run shows how far it got and how long each step took).
    ``once``: under the lock, skip the steps if ``d / "done"`` marks them
    run, and mark them when they end (two test modules share the world).

    One subprocess at a time: the port's 8-rank world is not started
    beside the JAX package's 8-device run, and the lock (a file in the
    directory that every xdist worker of the run shares, the parent of
    :func:`worlds_dir`) keeps the worlds of the two test modules that
    spawn them from overlapping.  A step that fails kills what it started
    before the test fails, and no later step starts."""
    import fcntl
    import json

    walls = {}
    with open(d.parent / "torch_worlds.lock", "w") as lock:
        t0 = time.perf_counter()
        fcntl.flock(lock, fcntl.LOCK_EX)
        walls["lock wait"] = time.perf_counter() - t0
        if once and (d / "done").exists():
            return
        for what, args, env_extra in steps:
            t0 = time.perf_counter()
            try:
                finish(start(args, env_extra), what)
            finally:
                walls[what] = time.perf_counter() - t0
                (d / "walls.json").write_text(json.dumps(walls, indent=1))
        if once:
            (d / "done").touch()


def worlds_dir(tmp_path_factory, name: str):
    """Where a test module's worlds write their results: under pytest-xdist
    a directory that every worker of the run shares, so that a worker that
    replaces a crashed one reads the results its predecessor finished (a
    ``done`` file marks them) instead of spawning the worlds again."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    d = base / f"torch_worlds_{name}"
    d.mkdir(exist_ok=True)
    return d


# ---------------------------------------------------------------------------
# The port's ranks
# ---------------------------------------------------------------------------


def _same_on_every_rank(t) -> bool:
    from repro_torch.dist.collectives import _all_gather

    g = _all_gather(t, None)
    return bool((g == g[0]).all())


def solve_rank(rank, dev, cases):
    import torch

    from repro_torch.solver import gmres, gmres_batched
    from repro_torch.solver.sharded import _plan_and_precond, wire_bytes
    from repro_torch.sparse import make_problem

    out = []
    for c in cases:
        t0 = time.perf_counter()
        A, target = make_problem(c["problem"], c["n"], device=dev)
        b = torch.from_numpy(rhs(A.shape[0]))
        kw = dict(storage=c["storage"], m=M, max_iters=MAX_ITERS,
                  target_rrn=target, shard=WORLD,
                  shard_transport=c["transport"], shard_matvec=c["mode"],
                  reorder=c.get("reorder", "auto"),
                  precond=c.get("precond"))
        if "method" in c:
            B = torch.from_numpy(batch_rhs(b.numpy(), c["k"]))
            res = gmres_batched(A, B, method=c["method"], **kw)
        else:
            res = [gmres(A, b, **kw)]
        plan, _ = _plan_and_precond(A, WORLD, kw["reorder"], c["mode"],
                                    kw["precond"])
        same = all(_same_on_every_rank(r.x) for r in res) and \
            _same_on_every_rank(torch.tensor(
                [[r.iterations, r.restarts, r.rrn] for r in res],
                dtype=torch.float64))
        out.append(dict(
            b=b.numpy(), mode=plan.matvec_mode, reorder=plan.reorder,
            results=[result_row(r) for r in res], same_on_every_rank=same,
            wire=(wire_bytes(res[0], plan, storage=c["storage"], m=M,
                             transport=c["transport"])
                  if "method" not in c else None)))
        _progress(rank, case_id(c), t0)
    return dict(cases=out, switches=_switched_solves(rank, dev))


def _progress(rank, what, t0):
    """Rank 0's wall of a finished case, on stderr (a failed world's
    message ends with them)."""
    if rank == 0:
        print(f"[world] {what}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)


def _switched_solves(rank, dev):
    """The float64 solves of :data:`SWITCHES`, each half switched through
    the port's own seam: ``_wrap_policy`` codes the dots,
    ``_partition_for`` the halo strips."""
    import torch

    import repro_torch.solver.sharded as S
    from repro_torch.solver import gmres
    from repro_torch.sparse import make_problem

    A, target = make_problem("synth:atmosmod", SWITCH_N, device=dev)
    b = torch.from_numpy(rhs(A.shape[0]))
    wrap, part = S._wrap_policy, S._partition_for
    out = {}
    try:
        for name, (dots, halo) in SWITCHES.items():
            t0 = time.perf_counter()
            S._wrap_policy = lambda pol, g, _c, d=dots: wrap(pol, g, d)
            S._partition_for = (lambda plan, r, g, dv, _c, h=halo:
                                part(plan, r, g, dv, h))
            out[name] = result_row(gmres(
                A, b, storage="float64", m=SWITCH_M, max_iters=MAX_ITERS,
                target_rrn=target, shard=WORLD, shard_matvec="halo"))
            _progress(rank, f"switched solve {name}", t0)
    finally:
        S._wrap_policy, S._partition_for = wrap, part
    return out


def collectives_rank(rank, dev, _):
    import torch
    import torch.distributed as dist

    from repro_torch.dist import collectives as C
    from repro_torch.sparse import make_problem, partition_matvec
    from repro_torch.sparse.plan import plan_operator

    def gather(t, group):
        return C._all_gather(t, group).numpy()

    out = {}
    A, _ = make_problem("synth:atmosmod", 512, device=dev)
    for P in GROUPS:
        group = dist.new_group(list(range(P)))
        if rank >= P:
            continue
        blk = plan_operator(A, P, matvec_mode="block3d").block
        inp = collective_inputs(P, blk.n_pad)

        def mine(a, n_local=N_LOCAL):
            """This rank's chunk of the last axis of ``a``."""
            return torch.from_numpy(
                a[..., rank * n_local:(rank + 1) * n_local].copy())

        for strips in STRIPS:
            for comp in (False, True):
                y = C.halo_exchange(mine(inp["x"]), strips, P, group,
                                    compressed=comp)
                out[("halo", P, strips, comp)] = gather(y, group)
            Y = C.halo_exchange(mine(inp["X"]), strips, P, group,
                                compressed=True)
            out[("halo_batched", P, strips)] = gather(Y, group)
        # the 3-D face exchange of the plan's block layout
        idx = [torch.as_tensor(ix[rank], dtype=torch.int64)
               for ix in blk.send_idx]
        for comp in (False, True):
            y = C.halo_exchange_3d(mine(inp["x3"], blk.n_local), idx,
                                   blk.rounds, group, compressed=comp)
            out[("halo3d", P, comp)] = gather(y, group)
        # reductions: each rank contributes its row of a (P, ...) array
        for k in PSUM_SIZES:
            v = torch.from_numpy(inp[("v", k)][rank].copy())
            out[("cpsum", P, k)] = gather(C.compressed_psum(v, group), group)
            out[("cpmean", P, k)] = gather(C.compressed_pmean(v, group),
                                           group)
            out[("psum", P, k)] = gather(C.psum(v, group), group)
        tree = {key: torch.from_numpy(inp["tree"][key][rank].copy())
                for key in inp["tree"]}
        got = C.compressed_psum(tree, group)
        out[("cpsum_tree", P)] = {k: gather(v, group) for k, v in got.items()}
        out[("gather", P)] = gather(C.gather_operand(mine(inp["x"]), group),
                                    group)
        # every partition of the atmosmod operator, plain and coded halo
        for mode in MATVEC_MODES:
            plan = plan_operator(A, P, reorder="none", matvec_mode=mode)
            for comp in (False, True):
                mv = partition_matvec(plan=plan, rank=rank, group=group,
                                      compressed_halo=comp)
                xe = plan.embed(torch.from_numpy(inp["xm"]))
                y = C.gather_operand(mv(mine(xe.numpy(), plan.n_local)),
                                     group)
                out[("matvec", P, mode, comp)] = (
                    plan.extract(y).numpy(), mv.mode)
    t0 = time.perf_counter()
    out["analysis"] = analysis_rank(rank, dev)
    _progress(rank, "the analysis gate's census and audits", t0)
    return out


@contextlib.contextmanager
def _planted(plant, rank):
    """A violation the census must find: ``"extra"`` adds a ``psum`` to
    every rank's rows-mode matvec (the wire model breaks), ``"rank"`` adds
    a recorded ``all_reduce`` to the last rank's record before the ranks
    exchange theirs (a rank-dependent call: the uniformity check breaks;
    issued for real it would hang the group)."""
    import torch

    import repro_torch.sparse as SP
    from repro_torch.dist import collectives as TC
    from repro_torch.dist.census import Call

    part, gather = SP.partition_matvec, TC.gather_objects

    def extra(*args, **kw):
        mv = part(*args, **kw)
        if mv.mode != "rows":
            return mv

        def planted(x):
            y = mv(x)
            TC.psum(torch.zeros((), dtype=torch.float64))
            return y
        return planted

    def one_rank(recorded):
        if rank == WORLD - 1:
            ranks = tuple(range(WORLD))
            recorded = dict(recorded, rows=recorded["rows"] + [
                Call("all_reduce", ranks, (), "float64", 8, "solve")])
        return gather(recorded)

    if plant == "extra":
        SP.partition_matvec = extra
    else:
        TC.gather_objects = one_rank
    try:
        yield
    finally:
        SP.partition_matvec, TC.gather_objects = part, gather


def analysis_rank(rank, dev):
    """The analysis gate's sharded legs on the world's 8 ranks: the census
    (``repro_torch.analysis.traffic.census_world``) as the gate runs it and
    with each planted violation, and the sharded recapture audit, also with
    the partition cache bypassed.  Findings as their dicts, the census's
    priced bytes, and this step's wall on rank 0."""
    import dataclasses

    import repro_torch.solver.sharded as S
    from repro_torch.analysis.traceaudit import audit_sharded_recapture
    from repro_torch.analysis.traffic import census_world
    from repro_torch.sparse import make_problem, rhs_for

    def rows(fs):
        return [dataclasses.asdict(f) for f in fs]

    t0 = time.perf_counter()
    out = {"info": {}}
    out["census"] = rows(census_world(rank, dev, info=out["info"]))
    for plant in ("extra", "rank"):
        with _planted(plant, rank):
            out[f"census_{plant}"] = rows(census_world(rank, dev))
    A, _ = make_problem("synth:atmosmod", 256, device=dev)
    b, _ = rhs_for(A, device=dev)
    out["calls"] = out["info"].pop("calls")
    out["recapture"] = rows(audit_sharded_recapture(A, b, shard=WORLD,
                                                    info=out["info"]))
    part = S._partition_for

    def uncached(plan, r, g, dv, c):
        return S.partition_matvec(plan=plan, rank=r, group=g,
                                  compressed_halo=c, device=dv)

    S._partition_for = uncached
    try:
        out["recapture_planted"] = rows(audit_sharded_recapture(
            A, b, shard=WORLD))
    finally:
        S._partition_for = part
    out["wall"] = time.perf_counter() - t0
    return out


def main():
    from repro_torch.dist import spawn

    which, path = sys.argv[1], sys.argv[2]
    if which == "solve":
        res = spawn(solve_rank, WORLD, SOLVE_CASES, device="cpu",
                    timeout_s=DEADLINE_S)
    else:
        res = spawn(collectives_rank, WORLD, None, device="cpu",
                    timeout_s=DEADLINE_S)
    with open(path, "wb") as f:
        pickle.dump(res, f)
