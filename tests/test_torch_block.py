"""The port's block-GMRES against the JAX package's, on the CPU.

The same numpy inputs go to both packages.  Tolerances:

* block stores (native, FRSZ2, mixed; segment padding included) and
  ``nbytes``: bit-identical, and they carry across ``convert`` both ways;
* ``block_qr``: 1e-13 relative, the same deflation flags, exact zero rows;
* the plain block Givens step against the JAX ``_block_apply_prior`` +
  ``_block_triangularize`` on the same slabs: 1e-13 relative (XLA may
  contract a multiply and an add where the port rounds both);
* solves against the JAX package (``gmres_batched``, block and vmap):
  per-column iterations within 1 and equal restarts (another summation
  order can move a borderline step); where the iterations agree,
  ``bytes_read`` and ``op_reads`` equal and X within 1e-10 relative; every
  column converged to the problem's target.  On these problems every
  column agrees exactly, so no ±1 is used;
* the port's two block drivers: the same bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.accessor import BlockBasisAccessor as JBlockAcc
from repro.core.accessor import format_by_name as jformat
from repro.solver import gmres_batched as jgmres_batched
from repro.solver.gmres import _block_apply_prior as j_apply_prior
from repro.solver.gmres import _block_triangularize as j_triangularize
from repro.solver.pipeline import block_qr as jblock_qr
from repro.sparse import make_problem as jmake
from repro.sparse import rhs_for as jrhs
from repro_torch.convert import csr_from_numpy, store_from_numpy, store_to_numpy
from repro_torch.core.accessor import BlockBasisAccessor, format_by_name
from repro_torch.kernels import ref
from repro_torch.solver import gmres, gmres_batched
from repro_torch.solver.pipeline import block_qr

torch.set_num_threads(2)


def _problem(name="synth:atmosmod", n=216):
    A, target = jmake(name, n)
    b, _ = jrhs(A)
    At = csr_from_numpy(np.asarray(A.indptr), np.asarray(A.indices),
                        np.asarray(A.data), A.shape, device="cpu")
    return A, At, np.array(b), target


def _rhs(b, p, seed):
    """The reference rhs plus p-1 random ones of the same norm."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((p, b.shape[0]))
    B *= np.linalg.norm(b) / np.linalg.norm(B, axis=1, keepdims=True)
    B[0] = b
    return B


def _tree(fn, store):
    """``fn`` on every array of a (possibly nested) store."""
    if isinstance(store, dict):
        return {k: _tree(fn, v) for k, v in store.items()}
    return fn(store)


def _leaves(store):
    if isinstance(store, dict):
        return [x for k in sorted(store) for x in _leaves(store[k])]
    return [np.asarray(store)]


def _bits(a):
    return a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "f" else a


FORMATS = ["float64", "frsz2_32", "frsz2_16", "mixed:2:frsz2_32"]


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("n", [1000, 256])
def test_block_store_and_nbytes_bit_identical_to_jax(name, n, rng):
    m, p = 5, 3
    jacc = JBlockAcc(fmt=jformat(name), m=m, p=p, n=n)
    tacc = BlockBasisAccessor(fmt=format_by_name(name), m=m, p=p, n=n)
    assert (tacc.n_seg, tacc.n_flat, tacc.nbytes()) == (
        jacc.n_seg, jacc.n_flat, jacc.nbytes())
    js, ts = jacc.empty(), tacc.empty()
    for j in range(m):
        W = rng.standard_normal((p, n))
        W[:, ::7] *= 2.0 ** rng.integers(-9, 9, size=W[:, ::7].shape)
        js = jacc.write_block(js, j, jnp.asarray(W))
        tacc.write_block(ts, j, torch.from_numpy(W))
    for a, b in zip(_leaves(store_to_numpy(ts, tacc.fmt)), _leaves(js),
                    strict=True):
        assert a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(
        tacc.read_block(ts, 2).numpy(), np.asarray(jacc.read_block(js, 2)))


@pytest.mark.parametrize("name", FORMATS)
def test_block_store_round_trips_through_convert(name, rng):
    m, p, n = 4, 3, 1000
    jacc = JBlockAcc(fmt=jformat(name), m=m, p=p, n=n)
    tacc = BlockBasisAccessor(fmt=format_by_name(name), m=m, p=p, n=n)
    js = jacc.empty()
    for j in range(m):
        js = jacc.write_block(js, j, jnp.asarray(rng.standard_normal((p, n))))
    ts = store_from_numpy(_tree(np.asarray, js), tacc.fmt, device="cpu")
    np.testing.assert_array_equal(tacc.read_all_blocks(ts).numpy(),
                                  np.asarray(jacc.read_all_blocks(js)))
    js2 = _tree(jnp.asarray, store_to_numpy(ts, tacc.fmt))
    np.testing.assert_array_equal(np.asarray(jacc.read_all_blocks(js2)),
                                  np.asarray(jacc.read_all_blocks(js)))


def test_block_qr_matches_jax_and_deflates(rng):
    W = rng.standard_normal((5, 64))
    W[2] = 2.0 * W[0] + W[1]                  # exactly dependent
    W[3] = 0.0                                # exactly zero
    Qj, Tj, dj = jblock_qr(jnp.asarray(W))
    Q, T, dep = block_qr(torch.from_numpy(W))
    assert dep.tolist() == [False, False, True, True, False]
    assert np.asarray(dj).tolist() == dep.tolist()
    assert not Q[2].any() and not Q[3].any()
    assert T[2, 2] == 0 and T[3, 3] == 0
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), rtol=0, atol=1e-13)
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), rtol=0,
                               atol=1e-13 * np.abs(W).max())
    recon = torch.einsum("kb,kn->bn", T, Q)
    assert float((recon - torch.from_numpy(W)).abs().max()) < 1e-12


@pytest.mark.parametrize("p", [1, 3])
def test_block_givens_step_matches_jax_rotations(p, rng):
    """Step by step, the plain block Givens step and the JAX cycle's
    ``_block_apply_prior`` + ``_block_triangularize`` on the same slabs, a
    deflated (all-zero) direction included."""
    m = 6
    mp = m * p
    L = ref.block_givens_layout(m, p)
    s = ref.block_givens_init_ref(m, p, "cpu")
    S = np.triu(rng.standard_normal((p, p)))
    s[L["G"]:L["G"] + p * p] = torch.from_numpy(S.ravel())
    R = np.zeros((mp + p, mp))
    G = np.zeros((mp + p, p))
    G[:p] = S
    cs, sn = np.ones((mp, p)), np.zeros((mp, p))
    bn = 1.0 + rng.random(p)
    for j in range(m):
        H = rng.standard_normal((j + 1, p, p))
        T = np.triu(rng.standard_normal((p, p)))
        if p > 1 and j == 2:
            T[1] = 0.0                          # a deflated direction
            H[:, :, 1] = 0.0
        ref.block_givens_step_ref(s, torch.from_numpy(H), torch.from_numpy(T),
                                  torch.tensor(j % 2 == 0),
                                  torch.from_numpy(bn), j, m, p, 0.0)
        slab = np.zeros((mp + p, p))
        slab[:(j + 1) * p] = H.reshape(-1, p)
        slab[(j + 1) * p:(j + 2) * p] = T
        jp = j * p
        sl = j_apply_prior(jnp.asarray(slab), jnp.asarray(cs),
                           jnp.asarray(sn), jp, p)
        sl, G2, csn, snn, gtail = j_triangularize(sl, jnp.asarray(G), jp, p)
        R[:, jp:jp + p] = np.asarray(sl)
        G = np.asarray(G2)
        cs[jp:jp + p], sn[jp:jp + p] = np.asarray(csn), np.asarray(snn)
        est = np.sqrt((np.asarray(gtail) ** 2).sum(axis=0)) / bn
        scale = max(np.abs(R).max(), 1.0)
        for key, want in (("R", R), ("G", G), ("cs", cs), ("sn", sn)):
            got = s[L[key]:L[key] + want.size].view(want.shape).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-13 * scale)
        got = s[L["est"] + jp:L["est"] + jp + p].numpy()
        np.testing.assert_allclose(got, est, rtol=1e-13, atol=0)
    assert float(s[L["extra"]]) == sum(j + 1 for j in range(0, m, 2))
    assert float(s[L["alive"]]) == 1.0


SOLVES = [("synth:stencil27", 512, "float64"), ("synth:stencil27", 512,
                                                 "frsz2_32"),
          ("synth:atmosmod", 1000, "float64"), ("synth:atmosmod", 1000,
                                                "frsz2_32")]


@pytest.mark.parametrize("name,n,fmt", SOLVES,
                         ids=[f"{a}-{b}-{c}" for a, b, c in SOLVES])
def test_block_and_vmap_solves_match_jax(name, n, fmt):
    A, At, b, target = _problem(name, n)
    B = _rhs(b, 4, seed=n)
    kw = dict(storage=fmt, m=20, target_rrn=target)
    ours, theirs = {}, {}
    for method in ("block", "vmap"):
        theirs[method] = jgmres_batched(A, jnp.asarray(B), method=method,
                                        **kw)
        ours[method] = gmres_batched(At, torch.from_numpy(B), method=method,
                                     **kw)
        for rt, rj in zip(ours[method], theirs[method], strict=True):
            assert rt.converged and bool(rj.converged)
            assert rt.rrn <= target
            assert abs(rt.iterations - rj.iterations) <= 1
            assert rt.restarts == rj.restarts
            if rt.iterations == rj.iterations:
                assert rt.bytes_read == float(rj.bytes_read)
                assert rt.op_reads == float(rj.op_reads)
                xj = np.asarray(rj.x)
                assert (np.linalg.norm(rt.x.numpy() - xj)
                        <= 1e-10 * np.linalg.norm(xj))
    # the modelled traffic of block against vmap, as the JAX package has it
    ratio = (sum(r.bytes_read for r in ours["block"])
             / sum(r.bytes_read for r in ours["vmap"]))
    jratio = (sum(float(r.bytes_read) for r in theirs["block"])
              / sum(float(r.bytes_read) for r in theirs["vmap"]))
    assert ratio == jratio
    # the host driver gives the device driver's bits
    host = gmres_batched(At, torch.from_numpy(B), method="block",
                         driver="host", **kw)
    for rh, rd in zip(host, ours["block"], strict=True):
        assert (rh.iterations, rh.restarts) == (rd.iterations, rd.restarts)
        assert (rh.bytes_read, rh.op_reads) == (rd.bytes_read, rd.op_reads)
        assert torch.equal(rh.x, rd.x)
        np.testing.assert_array_equal(rh.rrn_history, rd.rrn_history)


PIPELINES = [dict(storage="frsz2_32", ortho="cgs2"),
             dict(storage="mixed:2:frsz2_32"),
             dict(policy="adaptive:auto"),
             dict(storage="frsz2_32", precond="jacobi")]


@pytest.mark.parametrize("kw", PIPELINES,
                         ids=["-".join(map(str, k.values())) for k in PIPELINES])
def test_block_drivers_give_the_same_bits(kw):
    name = "synth:varcoef" if kw.get("precond") else "synth:atmosmod"
    _, At, b, target = _problem(name)
    B = torch.from_numpy(_rhs(b, 3, seed=1))
    rd = gmres_batched(At, B, method="block", m=15, target_rrn=target, **kw)
    rh = gmres_batched(At, B, method="block", m=15, target_rrn=target,
                       driver="host", **kw)
    for a, c in zip(rd, rh, strict=True):
        assert a.converged and c.converged
        assert (a.iterations, a.restarts) == (c.iterations, c.restarts)
        assert (a.bytes_read, a.op_reads) == (c.bytes_read, c.op_reads)
        assert torch.equal(a.x, c.x)


def test_block_p1_matches_scalar_gmres():
    _, At, b, target = _problem()
    bt = torch.from_numpy(b)
    kw = dict(storage="float64", m=20, target_rrn=target)
    blk = gmres_batched(At, bt[None, :], method="block", **kw)[0]
    sca = gmres(At, bt, **kw)
    assert (blk.iterations, blk.restarts) == (sca.iterations, sca.restarts)
    assert blk.bytes_read == sca.bytes_read and blk.op_reads == sca.op_reads
    assert abs(blk.rrn - sca.rrn) <= 1e-14
    assert float((blk.x - sca.x).abs().max()) < 1e-12


def test_converged_column_freezes():
    _, At, b, _ = _problem()
    B = torch.from_numpy(_rhs(b, 3, seed=3))
    x_sol = gmres(At, B[0], storage="float64", m=20, target_rrn=1e-12).x
    X0 = torch.stack([x_sol, torch.zeros_like(x_sol), torch.zeros_like(x_sol)])
    res = gmres_batched(At, B, X0=X0, method="block", storage="float64",
                        m=20, target_rrn=1e-10)
    assert all(r.converged for r in res)
    assert res[0].iterations < min(res[1].iterations, res[2].iterations)
    assert float((res[0].x - X0[0]).abs().max()) < 1e-8
    # every column carries an equal share of the shared traffic
    assert len({r.op_reads for r in res}) == 1
    assert len({r.bytes_read for r in res}) == 1


def test_batched_arguments_are_validated():
    _, At, b, _ = _problem(n=64)
    B = torch.from_numpy(_rhs(b, 2, seed=0))
    with pytest.raises(ValueError, match="method"):
        gmres_batched(At, B, method="nope")
    with pytest.raises(ValueError, match="driver"):
        gmres_batched(At, B, method="block", driver="nope")
    with pytest.raises(ValueError, match="batch"):
        gmres_batched(At, B[0], method="block")
    with pytest.raises(RuntimeError, match="process group"):
        gmres_batched(At, B, method="block", shard=2)


@pytest.mark.parametrize("eta", [0.3, 0.7071067811865475])
@pytest.mark.parametrize("fmt", ["float64", "frsz2_32"])
def test_block_fired_slots_equal_the_host_drivers_steps(fmt, eta):
    """A fixed trajectory (``target_rrn=0``: k full cycles of m block
    steps): the device cycle's ``fired`` slots equal the block steps where
    the host driver's block MGS re-orthogonalized (each result carries the
    shared flags), and ``bytes_read`` counts exactly those sweeps."""
    _, At, b, _ = _problem("synth:atmosmod", 512)
    B = torch.from_numpy(_rhs(b, 3, seed=2))
    m, k = 8, 2
    kw = dict(storage=fmt, m=m, max_iters=k * m, target_rrn=0.0, eta=eta,
              method="block")
    rd = gmres_batched(At, B, **kw)
    rh = gmres_batched(At, B, driver="host", **kw)
    acc = BlockBasisAccessor(fmt=format_by_name(fmt), m=m + 1, p=3,
                             n=b.shape[0], arith_dtype=torch.float64,
                             device="cpu")
    for a, c in zip(rd, rh, strict=True):
        assert a.fired.shape == (k, m)
        np.testing.assert_array_equal(a.fired, rd[0].fired)
        np.testing.assert_array_equal(a.fired, c.fired)
        assert torch.equal(a.x, c.x)
    fired = rd[0].fired
    extra = sum(j + 1 for cy in range(k) for j in range(m) if fired[cy, j])
    from repro_torch.solver.gmres import _cycle_row_reads

    want = (k * _cycle_row_reads(m, 1, 0) + extra) * acc.nbytes() / acc.m
    assert sum(r.bytes_read for r in rd) == pytest.approx(want, rel=1e-15)
    assert rd[0].bytes_read == rh[0].bytes_read


@pytest.mark.parametrize("fmt", ["float64", "frsz2_32"])
def test_block_mgs_fires_never_at_eta_0_and_always_at_eta_1_5(fmt):
    """The two extremes on one block trajectory, against the JAX package's
    block solve with the same ``eta``: the same iterations and
    ``bytes_read``, no extra sweep at eta 0 and every step's at 1.5."""
    A, At, b, _ = _problem("synth:atmosmod", 216)
    B = _rhs(b, 3, seed=3)
    m, k = 6, 2
    for eta, fired in ((0.0, False), (1.5, True)):
        kw = dict(storage=fmt, m=m, max_iters=k * m, target_rrn=0.0,
                  eta=eta, method="block")
        ours = gmres_batched(At, torch.from_numpy(B), **kw)
        host = gmres_batched(At, torch.from_numpy(B), driver="host", **kw)
        theirs = jgmres_batched(A, jnp.asarray(B), **kw)
        for rt, rh, rj in zip(ours, host, theirs, strict=True):
            assert (rt.fired == fired).all() and (rh.fired == fired).all()
            assert rt.iterations == rh.iterations == int(rj.iterations)
            assert rt.bytes_read == rh.bytes_read == float(rj.bytes_read)
            assert rt.op_reads == rh.op_reads == float(rj.op_reads)
            assert torch.equal(rt.x, rh.x)
