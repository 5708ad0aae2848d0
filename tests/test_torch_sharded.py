"""The port's sharded solve (``gmres(..., shard=8)``) against the JAX
package's, on 8 gloo ranks on the CPU.

One world a module: a subprocess spawns 8 ranks (``repro_torch.dist.spawn``,
a fresh ``file://`` rendezvous) that run every case of
``_torch_dist_cases.SOLVE_CASES``; another subprocess runs the same cases
through the JAX package on 8 emulated devices
(``--xla_force_host_platform_device_count=8``, as
``tests/test_sharded_driver.py`` does).  Both solve the problems' operators
(bit-equal in the two packages) with the same seeded numpy right-hand
sides.  They run one after the other, each under a deadline of its own,
under a file lock that keeps them from overlapping the 8-rank world of
``tests/test_torch_collectives.py`` (``_torch_dist_cases.run_worlds``),
and the results are compared here (a worker of pytest-xdist that replaces
a crashed one reads them from the run's shared directory,
``_torch_dist_cases.worlds_dir``).  Tolerances:

* ``converged``, ``stagnated``, the executed matvec mode and reorder equal;
* iterations: equal for the coded transports; within 1 for ``plain``,
  whose all-reduce sums in gloo's order where XLA's ``psum`` sums in its
  own, so a borderline restart may move by one iteration (the ROADMAP's
  rule for block3d);
* when the iterations agree: restarts, ``bytes_read``, ``op_reads`` and
  the modelled wire bytes (dots, norms, matvec, total:
  ``repro_torch.solver.sharded.wire_bytes`` against the reference's
  ``benchmarks/shard_wire.py`` accounting) exactly; the restart RRNs
  within 1e-6 relative plus 1e-14 absolute, the absolute term of
  ``tests/test_torch_driver.py``'s unsharded parity (the last restarts
  sit at 1e-12 to 1e-10, where the rounding of the residual's sums shows
  at 1e-5 relative, 5e-15 absolute on the row-scaled ``synth:varcoef``);
  ``x`` within 1e-10 relative;
* the final RRN: the two solutions' residuals differ by at most ``||A (x_t
  - x_j)|| / ||b||`` (the triangle inequality) plus 2e-15 for the rounding
  of the two residual computations.  A relative bound on the final RRN
  itself cannot hold: at ~3e-14 it sits at the rounding level of the f64
  residual, and local sums in another order (the ELL kernel's row sums,
  the squared norms) move it by 2e-6 to 1e-3 relative between two
  otherwise equal solves, for every transport;
* every rank returns the same ``x``, iterations, restarts and RRN bits.

The same world also solves float64 at n = 8000, m = 100 with the coded
transport's two halves switched one at a time (coded dots, coded halo
strips; ``_torch_dist_cases.SWITCHES``), through each package's own seam
(monkeypatched here, in the test's processes only): the port matches the
reference by the rules above, and both take more iterations from the coded
halo strips alone.

The CLI: ``python -m repro_torch.launch.solve --device cpu --shard 4``
spawns its own 4 ranks; its rows must equal the JAX CLI's at ``--shard 4``
in every field but the walls, the RRN and ``x_err`` (both within 1e-15,
the rounding level above).
"""
import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_cases as C
from repro.core.accessor import format_by_name as jformat
from repro.solver.pipeline import JacobiPreconditioner as JJacobi
from repro.sparse import make_problem as jmake
from repro_torch.solver.pipeline import JacobiPreconditioner
from repro_torch.solver.sharded import cycle_wire_bytes

CLI_ARGS = ["--n", "512", "--formats", "float64,frsz2_32",
            "--shard-transport", "compressed"]

_JAX_SCRIPT = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
import jax.numpy as jnp
import numpy as np
jax.config.update("jax_enable_x64", True)

import _torch_dist_cases as C
from benchmarks.shard_wire import cycle_wire_bytes
from repro.core.accessor import format_by_name
from repro.launch.solve import solve_suite
from repro.solver import gmres
from repro.solver.gmres import _cycle_row_reads, gmres_batched
from repro.solver.sharded import _plan_and_precond
from repro.sparse import make_problem

out = []
for c in C.SOLVE_CASES:
    A, target = make_problem(c["problem"], c["n"])
    b = jnp.asarray(C.rhs(A.shape[0]))
    kw = dict(storage=c["storage"], m=C.M, max_iters=C.MAX_ITERS,
              target_rrn=target, shard=C.WORLD,
              shard_transport=c["transport"], shard_matvec=c["mode"],
              reorder=c.get("reorder", "auto"), precond=c.get("precond"))
    if "method" in c:
        B = jnp.asarray(C.batch_rhs(np.asarray(b), c["k"]))
        res = gmres_batched(A, B, method=c["method"], **kw)
    else:
        res = [gmres(A, b, **kw)]
    plan, _ = _plan_and_precond(A, C.WORLD, kw["reorder"], c["mode"],
                                kw["precond"])
    wire = None
    if "method" not in c:
        r = res[0]
        row_bytes = format_by_name(c["storage"],
                                   arith_dtype=jnp.float64).nbytes(
            1, plan.n_local)
        cycles = max(r.restarts, 1)
        j_avg = min(max(r.iterations // cycles, 1), C.M)
        extra = max(r.bytes_read / row_bytes
                    - cycles * _cycle_row_reads(j_avg, 1), 0.0)
        reorth = int(round(extra / (j_avg + 1) / cycles))
        comp = c["transport"] != "plain"
        wire = cycle_wire_bytes(
            C.M, j_avg, reorth, passes=1, dots_compressed=comp,
            norms_compressed=c["transport"] == "compressed+norms",
            inner_mv_bytes=plan.matvec_wire_bytes(compressed=comp),
            residual_mv_bytes=plan.matvec_wire_bytes())
    out.append(dict(b=np.asarray(b), mode=plan.matvec_mode,
                    reorder=plan.reorder,
                    results=[C.result_row(r) for r in res], wire=wire))

# the coded transport's halves one at a time: the dots through
# _wrap_policy, the halo strips through _cached_sharded_solve's
# compressed_halo (its 13th argument)
import repro.solver.sharded as S
wrap, cached = S._wrap_policy, S._cached_sharded_solve


def halo_switched(*a, h):
    assert len(a) == 14
    return cached(*a[:12], h, a[13])


A, target = make_problem("synth:atmosmod", C.SWITCH_N)
b = jnp.asarray(C.rhs(A.shape[0]))
switches = {}
for name, (dots, halo) in C.SWITCHES.items():
    S._wrap_policy = lambda pol, ax, _c, d=dots: wrap(pol, ax, d)
    S._cached_sharded_solve = lambda *a, h=halo: halo_switched(*a, h=h)
    switches[name] = C.result_row(gmres(
        A, b, storage="float64", m=C.SWITCH_M, max_iters=C.MAX_ITERS,
        target_rrn=target, shard=C.WORLD, shard_matvec="halo"))
S._wrap_policy, S._cached_sharded_solve = wrap, cached

cli = solve_suite("synth:atmosmod", 512, ["float64", "frsz2_32"], shard=4,
                  shard_transport="compressed", verbose=False)
with open(sys.argv[1], "wb") as f:
    pickle.dump(dict(cases=out, cli=cli, switches=switches), f)
"""


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = C.worlds_dir(tmp_path_factory, "sharded")
    jax_pkl, port_pkl = d / "jax.pkl", d / "port.pkl"
    cli_json = d / "cli.json"
    if not (d / "done").exists():
        C.run_worlds(d, [
            ("the port's 8-rank world",
             ["-c", "import _torch_dist_cases as c; c.main()", "solve",
              str(port_pkl)], None),
            ("the port's --shard 4 CLI",
             ["-m", "repro_torch.launch.solve", "--device", "cpu",
              "--shard", "4", *CLI_ARGS, "--json", str(cli_json)], None),
            ("the JAX package's 8-device run",
             ["-c", _JAX_SCRIPT, str(jax_pkl)], {"JAX_PLATFORMS": "cpu"}),
        ])
        (d / "done").touch()
    with open(jax_pkl, "rb") as f:
        ref = pickle.load(f)
    with open(port_pkl, "rb") as f:
        port = pickle.load(f)
    return dict(ref=ref["cases"], port=port["cases"], cli_ref=ref["cli"],
                cli_port=json.loads(cli_json.read_text()),
                switches_ref=ref["switches"], switches_port=port["switches"])


def _assert_rrn_bound(rt, rj, A, b):
    """|rrn_t - rrn_j| <= ||A (x_t - x_j)|| / ||b|| + 2e-15."""
    dx = jnp.asarray(rt["x"] - rj["x"])
    gap = float(jnp.linalg.norm(A.matvec(dx)) / jnp.linalg.norm(b))
    assert abs(rt["rrn"] - rj["rrn"]) <= gap + 2e-15, (rt["rrn"], rj["rrn"],
                                                      gap)


def _assert_result(rt, rj, transport, A, b):
    assert rt["converged"] == rj["converged"]
    assert rt["stagnated"] == rj["stagnated"]
    if transport == "plain":
        assert abs(rt["iterations"] - rj["iterations"]) <= 1, (
            rt["iterations"], rj["iterations"])
    else:
        assert rt["iterations"] == rj["iterations"]
    if rt["iterations"] != rj["iterations"]:
        return False
    assert rt["restarts"] == rj["restarts"]
    assert rt["bytes_read"] == rj["bytes_read"]
    assert rt["op_reads"] == rj["op_reads"]
    np.testing.assert_allclose(rt["restart_rrns"], rj["restart_rrns"],
                               rtol=1e-6, atol=1e-14)
    xj = rj["x"]
    assert np.linalg.norm(rt["x"] - xj) <= 1e-10 * np.linalg.norm(xj)
    _assert_rrn_bound(rt, rj, A, b)
    return True


@pytest.mark.parametrize("i", range(len(C.SOLVE_CASES)),
                         ids=[C.case_id(c) for c in C.SOLVE_CASES])
def test_sharded_solve_matches_jax(worlds, i):
    c = C.SOLVE_CASES[i]
    pt, pj = worlds["port"][i], worlds["ref"][i]
    np.testing.assert_array_equal(pt["b"], pj["b"])
    assert (pt["mode"], pt["reorder"]) == (pj["mode"], pj["reorder"])
    assert pt["same_on_every_rank"]
    assert len(pt["results"]) == len(pj["results"])
    A, _ = jmake(c["problem"], c["n"])
    B = (C.batch_rhs(pj["b"], c["k"]) if "method" in c else pj["b"][None])
    for rt, rj, b in zip(pt["results"], pj["results"], B):
        assert rt["converged"], c
        same = _assert_result(rt, rj, c["transport"], A, jnp.asarray(b))
        if pt["wire"] is not None and same:
            assert pt["wire"] == pj["wire"]


@pytest.mark.parametrize("name", list(C.SWITCHES))
def test_coded_dots_and_halo_one_at_a_time_match_jax(worlds, name):
    """float64 at P = 8, n = 8000, with the coded transport's halves
    switched one at a time (``_torch_dist_cases.SWITCHES``): the port
    against the reference by the rules above (iterations equal where the
    dots are coded, within 1 where they ride the plain all-reduce)."""
    A, _ = jmake("synth:atmosmod", C.SWITCH_N)
    b = jnp.asarray(C.rhs(A.shape[0]))
    rt, rj = worlds["switches_port"][name], worlds["switches_ref"][name]
    assert rt["converged"] and rj["converged"]
    dots, _ = C.SWITCHES[name]
    _assert_result(rt, rj, "compressed" if dots else "plain", A, b)


def test_coded_halo_costs_float64_iterations_as_in_the_reference(worlds):
    """Why a float64 solve takes more iterations under the coded transport
    than under the plain one once P > 1 (on four H100s at n = 1,259,712:
    75 against 62): its halo strips, coded at l = 32, are lossier than its
    basis, so the cycle's matvec is inexact.  The coded dots alone keep
    the plain iterations.  Both packages show it."""
    for side in ("switches_port", "switches_ref"):
        it = {k: r["iterations"] for k, r in worlds[side].items()}
        assert abs(it["dots"] - it["plain"]) <= 2, (side, it)
        assert min(it["halo"], it["both"]) > it["plain"] + 2, (side, it)


def test_cases_cover_every_mode_and_method(worlds):
    """The executed matvec modes, methods and transports the cases reach."""
    modes = {p["mode"] for p in worlds["port"]}
    assert modes == {"halo", "rows", "replicated", "block3d"}
    assert {c.get("method") for c in C.SOLVE_CASES} == {None, "vmap",
                                                          "block"}
    assert any(p["reorder"] == "rcm" for p in worlds["port"])


def test_cli_shard_rows_match_jax_cli(worlds):
    rows_t, rows_j = worlds["cli_port"], worlds["cli_ref"]
    assert len(rows_t) == len(rows_j) == 2
    A, _ = jmake("synth:atmosmod", 512)
    for rt, rj in zip(rows_t, rows_j):
        assert rt.keys() == rj.keys()
        for k in rt:
            if k in ("wall_s", "wall_per_solve_s", "rrn", "x_err"):
                continue
            assert rt[k] == rj[k], k
        assert rt["shard"] == 4 and rt["shard_transport"] == "compressed"
        assert abs(rt["x_err"] - rj["x_err"]) <= 1e-15
        assert abs(rt["rrn"] - rj["rrn"]) <= 1e-15


def test_modelled_wire_bytes_formula_matches_reference():
    """The port's per-cycle wire model, term by term, against the
    reference's ``cycle_wire_bytes`` over both transports and
    re-orthogonalization counts."""
    from benchmarks.shard_wire import cycle_wire_bytes as jwire

    for m, j, reorth in ((20, 17, 0), (100, 100, 3), (30, 1, 1)):
        for dots_c in (False, True):
            for norms_c in (False, True):
                kw = dict(passes=1, dots_compressed=dots_c,
                          norms_compressed=norms_c, inner_mv_bytes=2928,
                          residual_mv_bytes=1536)
                assert cycle_wire_bytes(m, j, reorth, **kw) == jwire(
                    m, j, reorth, **kw)


@pytest.mark.parametrize("n_pad", [512, 520])
def test_jacobi_shard_local_slices_the_reference_diagonal(n_pad):
    """Jacobi's ``shard_local`` holds the rank's slice of the reference's
    identity-extended inverse diagonal, for every rank."""
    A, _ = jmake("synth:varcoef", 512)
    jj = JJacobi.from_operator(A).shard_local("ax", n_pad // 8, n_pad)
    full = np.asarray(jj.inv_diag)
    pt = JacobiPreconditioner(torch.from_numpy(np.array(A.diag())))
    for r in range(8):
        loc = pt.shard_local(r, n_pad // 8, n_pad)
        chunk = full[r * n_pad // 8:(r + 1) * n_pad // 8]
        np.testing.assert_array_equal(loc.inv_diag.numpy(), chunk)
        assert loc is pt.shard_local(r, n_pad // 8, n_pad)
        x = torch.ones(n_pad // 8, dtype=torch.float64)
        np.testing.assert_array_equal(loc.apply(x).numpy(), chunk)
    assert jformat("sharded:frsz2_32").name == "sharded:frsz2_32"
