#!/usr/bin/env python
"""Newton at scale: Bratu 2-D head-to-head at m >= 1023 (n >= 1M)
(VERDICT r3 item 8).

The reference's own Bratu driver runs m=100 (FDBratu2D.py:36-48); this
driver scales the identical nonlinear problem — F(u) = A u − α e^{−u},
J = A + α diag(e^{−u}), α=0.5, u0 = 1, tau=1e-12, minLinTol=1e-6,
freezePrec — to large grids:

  --side ours       Newton (host f64/longdouble outer) + mixed-precision
                    PCG inner + grid-GMG preconditioner probed ON DEVICE
                    from the f32 Jacobian (GMGPreconditionerType,
                    executor="grid") — zero per-step hierarchy uploads.
  --side reference  /root/reference PySolvers NewtonSolver + PCG +
                    AMG(numIters=5) on this host's CPU, handed the SAME
                    assembled operator (its own DOK assembly would cost
                    minutes before any solving).

Both sides solve the same system from the same start; success =
‖F(u)‖ <= r0·tau + tau (the reference's criterion, Newton.py:54).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _mg_levels(m: int) -> int:
    lev, mm = 1, m
    while mm > 31 and mm % 2 == 1:
        mm = (mm - 1) // 2
        lev += 1
    return lev


def run_ours(args, emit):
    import jax
    jax.config.update("jax_enable_x64", True)
    from pysolvers_tpu.utils.platform import enable_persistent_cache
    enable_persistent_cache()
    from pysolvers_tpu import (CommonSolverArgs, NewtonSolver, PCG,
                               SolverConfig)
    from pysolvers_tpu.linear.gmg import GMGPreconditionerType
    from pysolvers_tpu.problems import Bratu2D
    from pysolvers_tpu.problems.bratu import Bratu2DHostOuter
    from pysolvers_tpu.utils.platform import warmup_device

    warmup_device()
    m = args.m
    levels = _mg_levels(m)
    t0 = time.perf_counter()
    prob = Bratu2DHostOuter(Bratu2D(m=m, alpha=0.5, fmt="dia"))
    build_s = time.perf_counter() - t0

    def newton_once():
        inner = PCG(CommonSolverArgs(maxiter=400, tau=1e-12),
                    precond=GMGPreconditionerType(
                        dims=(m, m), num_iters=2, num_levels=levels,
                        smoother="jacobi"),
                    precision="mixed")
        ns = NewtonSolver(SolverConfig(maxiter=30, tau=1e-12),
                          solver=inner, min_lin_tol=1e-6,
                          freeze_prec=True)
        st = ns.solve(prob, np.ones(prob.n, dtype=np.longdouble))
        Fn = float(np.linalg.norm(
            prob.evalF(np.asarray(st.soln, dtype=np.float64))))
        return st, Fn

    st, Fn = newton_once()            # compile + first solve
    cold_s = time.perf_counter() - t0 - build_s
    solves = []
    for _ in range(max(args.runs, 1)):
        t0 = time.perf_counter()
        st, Fn = newton_once()        # steady state
        solves.append(time.perf_counter() - t0)
    solve_s = sorted(solves)[len(solves) // 2]
    emit(dict(config=f"Bratu{m}+Newton+PCG+GMG{levels}(grid,mixed)",
              side="ours", n=m * m,
              time_s=round(build_s + solve_s, 3),
              build_s=round(build_s, 3), solve_s=round(solve_s, 3),
              solve_range=[round(min(solves), 3), round(max(solves), 3)],
              cold_s=round(cold_s, 3), runs=len(solves),
              newton_iters=int(st.iters), final_Fnorm=Fn,
              success=bool(st.success)))


def run_reference(args, emit):
    from run_reference import _make_stubs
    _make_stubs()
    from run_reference import STUBS
    sys.path.insert(0, STUBS)
    sys.path.insert(0, "/root/reference")
    import scipy.sparse as sp
    from PySolvers import CommonSolverArgs
    from PySolvers.Linear import PCG, AMG, RightIC
    from PySolvers.Nonlinear import NewtonSolver

    import pysolvers_tpu as pst

    m = args.m
    # the SAME operator values ours solves (problems/bratu.py assembles
    # the SPD 2-D FD Laplacian; the reference's A = -FDLaplacian2D is
    # the same sign convention) — assembled vectorized so the reference
    # measurement is solver time, not its Python DOK loop
    H = pst.problems.fd_laplacian_2d(m, dtype=np.float64)
    S = sp.csr_matrix((H.data, H.indices, H.indptr), shape=H.shape)
    alpha = 0.5

    class Func:
        def evalF(self, u):
            return S @ u - alpha * np.exp(-u)

        def evalJ(self, u):
            J = S.copy()
            J.setdiag(S.diagonal() + alpha * np.exp(-u))
            return J

    # --ref-inner: the FDBratu2D driver's own config is PCG+AMG(5)
    # (FDBratu2D.py:36-48) — measured here to STALL at m>=255 (PCG
    # relative residual 0.041 -> 0.035 over ~400 iterations; the
    # 5-iteration nonsymmetric V-cycle preconditioner breaks CG).  "ic"
    # swaps the inner preconditioner for RightIC (the reference's
    # PCGExample_IC config), which converges — the anchor datum for the
    # scaling fit (VERDICT r4 item 6).
    if args.ref_inner == "amg":
        inner = PCG(control=CommonSolverArgs(tau=1e-12,
                                             maxiter=args.ref_maxiter),
                    precond=AMG(numIters=5))
        cfg = f"Bratu{m}+Newton+PCG+AMG5(reference)"
    else:
        inner = PCG(control=CommonSolverArgs(tau=1e-12,
                                             maxiter=args.ref_maxiter),
                    precond=RightIC())
        cfg = f"Bratu{m}+Newton+PCG+IC(reference)"
    t0 = time.perf_counter()
    solver = NewtonSolver(
        control=CommonSolverArgs(tau=1e-12, maxiter=30),
        solver=inner,
        fixLinTol=False, minLinTol=1e-6, freezePrec=True)
    stat = solver.solve(Func(), np.ones(m * m))
    wall = time.perf_counter() - t0
    x = stat.soln()
    Fn = (float(np.linalg.norm(S @ x - alpha * np.exp(-x)))
          if x is not None else float("nan"))
    emit(dict(config=cfg,
              side="reference", n=m * m, time_s=round(wall, 3),
              newton_iters=int(stat.iters()), final_Fnorm=Fn,
              success=bool(stat.success())))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", choices=["ours", "reference"],
                    default="ours")
    ap.add_argument("--m", type=int, default=1023)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--ref-inner", choices=["amg", "ic"], default="ic")
    ap.add_argument("--ref-maxiter", type=int, default=2000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    if args.side == "ours":
        run_ours(args, emit)
    else:
        run_reference(args, emit)


if __name__ == "__main__":
    main()
