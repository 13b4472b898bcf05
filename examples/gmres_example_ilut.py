#!/usr/bin/env python
"""GMRES + ILUT on the Debye-Hückel suite.

Parity with reference examples/GMRESExample_ILUT.py:10-29.
"""
import argparse

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import pysolvers_tpu as pst


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshLev", type=int, default=10)
    ap.add_argument("--maxiter", type=int, default=100)
    ap.add_argument("--tau", type=float, default=1e-8)
    ap.add_argument("--precision", default="native",
                    choices=["native", "mixed"],
                    help="mixed = f32 device kernels + f64 host-residual"
                         " refinement (the f32 route to tight taus)")
    from pysolvers_tpu.utils.platform import (add_platform_arg,
                                               enable_persistent_cache,
                                               ensure_platform)
    add_platform_arg(ap)
    args = ap.parse_args()
    ensure_platform(args.platform)
    enable_persistent_cache()

    A, x_exact, b = pst.problems.dh_test_problem(args.meshLev)
    solver = pst.GMRES(
        pst.CommonSolverArgs(maxiter=args.maxiter, tau=args.tau,
                             showFinal=True),
        precond=pst.RightILUT(drop_tol=1e-3, fill_factor=15),
        precision=args.precision,
    ).make_solver()
    st = solver.solve(A, b)
    err = np.linalg.norm(np.asarray(st.soln) - x_exact)
    print(f"error norm = {err:.6e}")
    return 0 if st.success else 1


if __name__ == "__main__":
    raise SystemExit(main())
