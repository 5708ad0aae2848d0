"""The composable cycle pipeline over the synthetic CFD suite (paper Sec. VI).

  python -m repro_torch.examples.solve_cfd [--n 4000]
  python -m repro_torch.examples.solve_cfd --device cpu

The JAX package's ``examples/solve_cfd.py`` ``pipeline_demo``: Jacobi
preconditioning against the identity on the variable-coefficient problem,
then the adaptive per-cycle precision policy (float64 -> frsz2_32 ->
frsz2_16) against static frsz2_32, printing the reference's lines.  The
reference's Fig. 7/8 (convergence per problem x format) and Fig. 11
(modelled end-to-end speedup) sections drive ``benchmarks/``; they come
with the port's benchmark.
"""
from __future__ import annotations

import argparse

from repro_torch.solver import gmres
from repro_torch.sparse import make_problem, rhs_for


def pipeline_demo(n: int, device="cuda") -> tuple[list[str], dict]:
    """Preconditioner hook + adaptive precision policy in one place: the
    lines the reference prints, and the four results (``identity``,
    ``jacobi``, ``static``, ``adaptive``)."""
    lines = ["-- preconditioner hook: Jacobi on the row-scaled problem --"]
    A, target = make_problem("synth:varcoef", n, device=device)
    b, _ = rhs_for(A, device=device)
    kw = dict(m=50, max_iters=20000, target_rrn=target)
    plain = gmres(A, b, **kw)
    jac = gmres(A, b, precond="jacobi", **kw)
    lines.append(f"  identity: iters={plain.iterations:6d} "
                 f"rrn={plain.rrn:.2e}")
    lines.append(f"  jacobi  : iters={jac.iterations:6d} rrn={jac.rrn:.2e}  "
                 f"({plain.iterations / max(jac.iterations, 1):.0f}x fewer)")

    lines.append("-- adaptive precision policy: f64 -> frsz2_32 -> "
                 "frsz2_16 --")
    A, target = make_problem("synth:atmosmod", n, device=device)
    b, _ = rhs_for(A, device=device)
    kw = dict(m=10, max_iters=20000, target_rrn=target)
    static = gmres(A, b, storage="frsz2_32", **kw)
    adap = gmres(A, b, policy="adaptive", **kw)
    lines.append(f"  static frsz2_32: iters={static.iterations:6d} "
                 f"rrn={static.rrn:.2e} "
                 f"read={static.bytes_read / 1e9:.3f} GB")
    lines.append(f"  adaptive       : iters={adap.iterations:6d} "
                 f"rrn={adap.rrn:.2e} read={adap.bytes_read / 1e9:.3f} GB")
    return lines, dict(identity=plain, jacobi=jac, static=static,
                       adaptive=adap)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    print("== cycle pipeline: preconditioner + precision policy ==")
    for line in pipeline_demo(args.n, args.device)[0]:
        print(line)


if __name__ == "__main__":
    main()
