"""The port's ELL SpMV against the JAX package's, on the CPU.

On the CPU ``ops.ell_spmv`` runs the plain versions (``kernels/ref.py``);
the hand-written kernels are held against those on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Tolerance, relative to the largest |y|: 1e-12 for f64 values, 1e-6 for
f32.  The plain version sums each row's products in slot order, starting
from 0, as the kernel does.  XLA's row sum on the CPU (the JAX gather sum,
and the Pallas kernel in interpret mode) gives the same bits in f64 here,
but may reassociate an f32 sum: up to 8e-8 relative was seen on these
inputs, an f32 rounding or two.  Either bound catches a wrong gather or a
lost padding slot at once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frsz2 as JF
from repro.kernels import ops as jops
from repro.sparse.csr import ELL as JELL
from repro_torch.convert import csr_from_numpy
from repro_torch.core import frsz2 as TF
from repro_torch.kernels import ops, ref
from repro_torch.sparse import make_problem

torch.set_num_threads(2)

_NP = {torch.float64: np.float64, torch.float32: np.float32}
_J = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _random_ell(rng, nr, nc, w, dtype):
    """Random ELL with padding slots (val 0, col 0) and two empty rows."""
    cols = rng.integers(0, nc, (nr, w))
    vals = rng.standard_normal((nr, w))
    pad = rng.random((nr, w)) < 0.25
    pad[[0, nr // 2]] = True
    cols[pad] = 0
    vals[pad] = 0.0
    return cols.astype(np.int32), vals.astype(_NP[dtype])


_TOL = {torch.float64: 1e-12, torch.float32: 1e-6}


def _close(yt, yj, tol=1e-12):
    yt, yj = np.asarray(yt, np.float64), np.asarray(yj, np.float64)
    assert yt.shape == yj.shape
    assert np.abs(yt - yj).max() <= tol * max(np.abs(yj).max(), 1e-300)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("nr,nc,w", [(300, 300, 7), (389, 1001, 1),
                                     (256, 97, 13), (5, 5, 40)])
def test_plain_ell_matches_jax_gather_and_pallas(dtype, nr, nc, w, rng):
    cols, vals = _random_ell(rng, nr, nc, w, dtype)
    x = rng.standard_normal(nc).astype(_NP[dtype])
    E = JELL(jnp.asarray(cols), jnp.asarray(vals), (nr, nc))
    yj = E.matvec(jnp.asarray(x), kernel=False)
    yk = jops.ell_spmv(E.vals, E.cols, jnp.asarray(x), interpret=True)
    yt = ref.ell_spmv_ref(torch.from_numpy(vals), torch.from_numpy(cols),
                          torch.from_numpy(x))
    assert yt.dtype == dtype
    _close(yt.numpy(), yj, _TOL[dtype])
    _close(yt.numpy(), yk, _TOL[dtype])
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(ops.ell_spmv(torch.from_numpy(vals),
                                    torch.from_numpy(cols),
                                    torch.from_numpy(x)), yt)


@pytest.mark.parametrize("l", [32, 16])
@pytest.mark.parametrize("dtype,bs", [(torch.float64, 32),
                                      (torch.float32, 128)], ids=str)
def test_plain_coded_operand_matches_jax_fused(l, dtype, bs, rng):
    """The JAX fused path (Pallas in interpret mode) against the port's
    decompress-then-gather, from the same codes."""
    nr, nc, w = 389, 512, 7          # nc a multiple of 128: the TPU tiling
    cols, vals = _random_ell(rng, nr, nc, w, dtype)
    x = rng.standard_normal(nc).astype(_NP[dtype])
    js = JF.FrszSpec(bs=bs, l=l, dtype=_J[dtype])
    ts = TF.FrszSpec(bs=bs, l=l, dtype=dtype)
    jb = JF.compress(jnp.asarray(x), js)
    E = JELL(jnp.asarray(cols), jnp.asarray(vals), (nr, nc))
    yj = jops.ell_spmv(E.vals, E.cols, jb, interpret=True)
    assert yj is not None                          # the fused kernel ran
    bc = ops.compress(torch.from_numpy(x), ts)
    assert np.array_equal(bc.exps.numpy(), np.asarray(jb.exps))
    yt = ops.ell_spmv(torch.from_numpy(vals), torch.from_numpy(cols), bc)
    _close(yt.numpy(), yj, _TOL[dtype])
    assert torch.equal(yt, ref.ell_spmv_ref(torch.from_numpy(vals),
                                            torch.from_numpy(cols),
                                            TF.decompress(bc)))


def test_csr_matvec_goes_through_the_wrapper_and_launches_nothing(rng):
    A, _ = make_problem("synth:atmosmod", 300, device="cpu")
    x = torch.from_numpy(rng.standard_normal(A.shape[0]))
    ops.reset_launches()
    y = A.matvec(x)
    E = A.to_ell()
    assert torch.equal(y, ref.ell_spmv_ref(E.vals, E.cols, x))
    spec = TF.FrszSpec(bs=32, l=32, dtype=torch.float64)
    bc = ops.compress(x, spec)
    assert torch.equal(A.matvec(bc), A.matvec(TF.decompress(bc)))
    assert torch.equal(A.matvec(x, kernel=False), y)
    assert all(v == 0 for v in ops.LAUNCHES.values()), ops.LAUNCHES


def test_ell_wrapper_validates_and_refuses_a_kernel_on_the_cpu(rng):
    cols, vals = _random_ell(rng, 20, 20, 3, torch.float64)
    V, C = torch.from_numpy(vals), torch.from_numpy(cols)
    x = torch.from_numpy(rng.standard_normal(20))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.ell_spmv(V, C, x, kernel=True)
    with pytest.raises(ValueError):
        ops.ell_spmv(V[0], C, x)
    with pytest.raises(ValueError):          # (q, nc) is a batch; 3-D is not
        ops.ell_spmv(V, C, x[None, None])
    bc = ops.compress(x[None], TF.FrszSpec(bs=4, l=32, dtype=torch.float64))
    with pytest.raises(ValueError, match="one vector"):
        ops.ell_spmv(V, C, bc)


def test_port_operator_matches_jax_operator(rng):
    """On a problem operator the port's matvec agrees with the JAX
    package's, so solves of both start from the same data."""
    from repro.sparse import make_problem as jmake

    Aj, _ = jmake("synth:varcoef", 343)
    At = csr_from_numpy(np.asarray(Aj.indptr), np.asarray(Aj.indices),
                        np.asarray(Aj.data), Aj.shape, device="cpu")
    x = rng.standard_normal(At.shape[0])
    yj = np.asarray(Aj.to_ell().matvec(jnp.asarray(x), kernel=False))
    _close(At.matvec(torch.from_numpy(x)).numpy(), yj)


def test_ell_body_names_the_widths_the_source_tiles():
    """``ell_spmv.body`` names the body a width runs: the tiled one at the
    widths ``csrc/ell_spmv.cu`` compiles (its ``case`` labels), the row
    kernel at every other (aniso2d's 5, lung's 4)."""
    import pathlib
    import re

    from repro_torch.kernels import ell_spmv as KE

    src = (pathlib.Path(KE.__file__).parent / "csrc" / "ell_spmv.cu")
    cases = {int(c) for c in re.findall(r"case (\d+):\s*\n\s*ell_tile",
                                        src.read_text())}
    assert cases == set(KE.TILE_WIDTHS)
    assert [KE.body(w) for w in (4, 5, 7, 27, 28)] == [
        "row", "row", "tile", "tile", "row"]
