#!/usr/bin/env python
"""BDIA as a solver citizen: preconditioned 1e-10 solves + multi-RHS
amortization on the planar block-DIA kernel (VERDICT r3 item 2 "Done").

Problem: vector 2-D Laplacian, b dofs/node (dense b x b blocks on the
5-point stencil).  Rows:

  solve      solve(BdiaMatrix, b, precond="bjacobi", precision="mixed")
             to tau=1e-10 — wall, iterations, per-iteration seconds and
             the implied per-iteration kernel rate (one operator pass +
             one block-Jacobi apply per CG step).
  multi      lockstep blocked CG (bdia_spmm, one operator pass per step
             for all k RHS) vs k=1, marginal-cost per column — the
             amortization factor the kernel's arithmetic intensity buys.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=648)
    ap.add_argument("--b", type=int, default=5)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    from pysolvers_tpu.utils.platform import enable_persistent_cache
    enable_persistent_cache()
    import jax.numpy as jnp
    import pysolvers_tpu as pst
    from pysolvers_tpu.sparse.bdia import BdiaMatrix

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    m, b, k = args.m, args.b, args.k
    H = pst.problems.fd_vector_laplacian_2d(m, b=b, coupling=0.2,
                                            dtype=np.float64)
    n, nnz = H.shape[0], H.nnz
    Ad = BdiaMatrix.from_host_csr(H, b=b)          # f64; mixed casts down
    rng = np.random.default_rng(0)
    x_true = rng.random(n)
    rhs = H.matvec(x_true)

    # --- preconditioned mixed solves to 1e-10 --------------------------
    # 'bjacobi' is the weak fast lane (r4: 1793 iterations); 'bmg' is
    # the STRONG planar option (VERDICT r4 item 5): dof-decoupled
    # multigrid, zero per-apply transposes, O(10) iterations
    b_norm = float(np.linalg.norm(rhs))
    wall_by_prec = {}
    for prec in ("bjacobi", "bmg"):
        walls, sts = [], []
        for r in range(args.runs):
            t0 = time.perf_counter()
            st = pst.solve(Ad, rhs, tau=1e-10, maxiter=4000,
                           precond=prec, precision="mixed")
            walls.append(time.perf_counter() - t0)
            sts.append(st)
            err = float(np.abs(np.asarray(st.soln) - x_true).max()
                        / np.abs(x_true).max())
            print(f"  [{prec} run {r}] {walls[-1]:.2f}s iters={st.iters} "
                  f"resid={float(st.resid):.3e} err={err:.3e} "
                  f"success={st.success}", flush=True)
        st = sts[-1]
        wall = sorted(walls)[len(walls) // 2]
        wall_by_prec[prec] = wall
        per_it = wall / max(int(st.iters), 1)
        err = float(np.abs(np.asarray(st.soln) - x_true).max()
                    / np.abs(x_true).max())
        emit(dict(config=f"VecLap2D(m={m},b={b})+CG+{prec} mixed 1e-10",
                  n=n, nnz=nnz, runs=args.runs, wall_s=round(wall, 3),
                  wall_range=[round(min(walls), 3), round(max(walls), 3)],
                  iters=int(st.iters), success=bool(st.success),
                  resid=float(st.resid), rel_resid=float(st.resid) / b_norm,
                  solution_err_rel=err,
                  per_iter_ms=round(per_it * 1e3, 3),
                  # one kernel pass per iteration; the implied rate must
                  # reflect the planar kernel, not a fallback path
                  implied_gnnzs_per_pass=round(nnz / per_it / 1e9, 2)))

    # --- CONVERGED lockstep multi-RHS at 1e-10 (blocked mixed route:
    # per-column f64 residuals, f32 lockstep inner) --------------------
    X_true_k = rng.random((n, args.k))
    B_nat = np.stack([H.matvec(X_true_k[:, j]) for j in range(args.k)],
                     axis=1)
    t0 = time.perf_counter()
    st_m = pst.solve(Ad, B_nat, tau=1e-10, maxiter=4000,
                     precond="bjacobi", precision="mixed")
    wall_m = time.perf_counter() - t0
    Xm = np.asarray(st_m.soln)
    col_errs = [float(np.abs(Xm[:, j] - X_true_k[:, j]).max()
                      / np.abs(X_true_k[:, j]).max())
                for j in range(args.k)]
    col_resids = [float(np.linalg.norm(B_nat[:, j] - H.matvec(Xm[:, j]))
                        / np.linalg.norm(B_nat[:, j]))
                  for j in range(args.k)]
    emit(dict(config=f"VecLap2D(m={m},b={b})+CG-multi mixed 1e-10 "
                     f"k={args.k} bjacobi",
              n=n, nnz=nnz, k=args.k, wall_s=round(wall_m, 3),
              iters=int(st_m.iters), success=bool(st_m.success),
              col_rel_resids=[round(r, 14) for r in col_resids],
              col_solution_errs=[round(e, 14) for e in col_errs],
              amortization_at_tol=round(
                  args.k * wall_by_prec["bjacobi"] / wall_m, 2)))

    # --- multi-RHS amortization (native f32 lockstep in the planar row
    # layout: the operator pass and the block-Jacobi apply are planar
    # SpMMs; solve(BdiaMatrix, B) rides the same route) ----------------
    from pysolvers_tpu.linear.block_precond import block_jacobi_bdia_matrix
    from pysolvers_tpu.linear.krylov import cg_solve_multi_rows
    from pysolvers_tpu.ops.spmv import bdia_spmm_rows

    A32 = Ad.astype(jnp.float32)
    M32 = block_jacobi_bdia_matrix(A32)
    X = rng.random((n, k)).astype(np.float32)
    B = np.stack([H.matvec(X[:, j]) for j in range(k)], axis=1)

    def timed_multi(kk, reps=3):
        nb, bb = A32.nb, A32.b
        Bp = jnp.asarray(B[:, :kk].T.reshape(kk, nb, bb)
                         .transpose(0, 2, 1).reshape(kk, n),
                         dtype=jnp.float32)

        @jax.jit
        def run(A, M, Bp):
            X, st, _ = cg_solve_multi_rows(
                lambda V: bdia_spmm_rows(A, V), Bp, maxiter=600,
                tau=1e-5, precond=lambda V: bdia_spmm_rows(M, V))
            return X, st.k

        Xs, ks = run(A32, M32, Bp)
        jax.block_until_ready(Xs)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            Xs, ks = run(A32, M32, Bp)
            jax.block_until_ready(Xs)
            best = min(best, time.perf_counter() - t0)
        return best, int(np.asarray(ks).max())

    t1, it1 = timed_multi(1)
    tk, itk = timed_multi(k)
    # per-column per-iteration marginal cost
    c1 = t1 / it1
    ck = tk / itk / k
    emit(dict(config=f"VecLap2D(m={m},b={b})+CG-multi bjacobi k={k}",
              n=n, nnz=nnz, iters_k1=it1, iters_k=itk,
              t_k1_s=round(t1, 4), t_k_s=round(tk, 4),
              per_col_iter_ms_k1=round(c1 * 1e3, 3),
              per_col_iter_ms_k=round(ck * 1e3, 3),
              amortization=round(c1 / ck, 2)))


if __name__ == "__main__":
    main()
