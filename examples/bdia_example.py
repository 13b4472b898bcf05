#!/usr/bin/env python
"""Multi-dof (block-structured) solve on the planar block-DIA format.

The reference has no multi-dof problem family (its suite is scalar —
examples/FDLaplacian2D.py, DHTestProblem.py); this driver exercises the
BSR-class capability added here: a vector 2-D Laplacian with b coupled
fields per node (problems.fd_vector_laplacian_2d), solved by CG with the
operator in planar block-DIA form (sparse/bdia.py — dense b×b blocks
streamed gather-free).
"""
import argparse

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import pysolvers_tpu as pst


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=48,
                    help="interior grid points per side")
    ap.add_argument("--b", type=int, default=3, help="dofs per node")
    ap.add_argument("--coupling", type=float, default=0.3)
    ap.add_argument("--maxiter", type=int, default=3000)
    ap.add_argument("--tau", type=float, default=1e-10)
    from pysolvers_tpu.utils.platform import (add_platform_arg,
                                              enable_persistent_cache,
                                              ensure_platform)
    add_platform_arg(ap)
    args = ap.parse_args()
    ensure_platform(args.platform)
    enable_persistent_cache()

    import jax.numpy as jnp
    from pysolvers_tpu.ops import matvec

    A = pst.problems.fd_vector_laplacian_2d(args.m, b=args.b,
                                            coupling=args.coupling)
    n = A.shape[0]
    rng = np.random.default_rng(0)
    x_exact = rng.random(n)
    b_rhs = A.matvec(x_exact)

    Ad = pst.BdiaMatrix.from_host_csr(A, b=args.b, dtype=np.float32)
    print(f"n={n} (m={args.m}, b={args.b}), block offsets="
          f"{len(Ad.offsets)}, stored/{'nnz'}={Ad.nnz_stored / A.nnz:.2f}")

    # solve in PLANAR ordering (one reorder per solve, zero per matvec).
    # f64-grade answers from the f32 planes: rr-CG with the f64 block-DIA
    # copy as the replaced-residual operator (linear/krylov.cg_solve_rr)
    from pysolvers_tpu.linear.krylov import cg_solve_rr
    Ad64 = pst.BdiaMatrix.from_host_csr(A, b=args.b, dtype=np.float64)
    bp64 = Ad.to_planar(jnp.asarray(b_rhs))
    bn = float(np.linalg.norm(b_rhs))
    x, st, _ = cg_solve_rr(lambda v: matvec(Ad, v), bp64 / bn,
                           mv_hi=lambda v: matvec(Ad64, v),
                           maxiter=args.maxiter, tau=args.tau)
    x = x * bn
    xu = np.asarray(Ad.from_planar(x), dtype=np.float64)
    err = np.linalg.norm(xu - x_exact)
    print(f"CG: iters={int(st.k)} resid={float(st.resid):.3e} "
          f"reason={int(st.reason)}")
    print(f"error vs exact: {err:.3e}")
    if int(st.reason) != 1:
        raise SystemExit("solve did not converge")


if __name__ == "__main__":
    main()
