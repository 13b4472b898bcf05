#!/usr/bin/env python
"""PCG + AMG preconditioner on the Debye-Hückel suite.

Parity with reference examples/PCGExample_AMG.py:11-34 (AMG numIters=2).
"""
import argparse

import numpy as np
import jax

jax.config.update("jax_enable_x64", True)

import pysolvers_tpu as pst
from pysolvers_tpu.utils.timing import Timer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshLev", type=int, default=10)
    ap.add_argument("--maxiter", type=int, default=100)
    ap.add_argument("--tau", type=float, default=1e-8)
    ap.add_argument("--precision", default="native",
                    choices=["native", "mixed"],
                    help="mixed = f32 device kernels + f64 host-residual"
                         " refinement (the f32 route to tight taus)")
    ap.add_argument("--numIters", type=int, default=2)
    from pysolvers_tpu.utils.platform import (add_platform_arg,
                                               enable_persistent_cache,
                                               ensure_platform)
    add_platform_arg(ap)
    args = ap.parse_args()
    ensure_platform(args.platform)
    enable_persistent_cache()

    A, x_exact, b = pst.problems.dh_test_problem(args.meshLev)
    with Timer("total solve"):
        solver = pst.PCG(
            pst.CommonSolverArgs(maxiter=args.maxiter, tau=args.tau,
                                 showFinal=True),
            precond=pst.AMG(num_iters=args.numIters, num_levels=2),
            precision=args.precision,
        ).make_solver()
        st = solver.solve(A, b)
    err = np.linalg.norm(np.asarray(st.soln) - x_exact)
    print(f"error norm = {err:.6e}")
    Timer.report()
    return 0 if st.success else 1


if __name__ == "__main__":
    raise SystemExit(main())
