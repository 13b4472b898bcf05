#!/usr/bin/env python
"""Blocked multi-RHS CG amortization on the device kernels.

Measures the per-iteration cost of ``cg_solve_multi`` at k = 1 and
k = K rhs on a 2-D FD Laplacian (DIA kernel).  On a bandwidth-bound
SpMV the operator pass dominates, so a blocked iteration serving K
columns should cost far less than K single-column iterations — the
amortization ratio is the headline.  (On CPU the XLA SpMV is
compute-bound and the ratio is ~1; see PARITY.md.)

Honest-timing method (see bench.py): identical solves at two different
maxiter values, per-iteration cost = (t_long - t_short) / (k_long -
k_short); fixed dispatch overhead cancels, tau=0 pins the iteration
counts, and a scalar fetch forces completion.

Usage: python benchmarks/multi_rhs.py [--m 1448] [--k 8]
"""
import argparse
import json
import time

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=1448)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from pysolvers_tpu.utils.platform import enable_persistent_cache
    enable_persistent_cache()
    import jax.numpy as jnp

    import pysolvers_tpu as pst
    from pysolvers_tpu.linear.krylov import cg_solve_multi
    from pysolvers_tpu.ops import matmat
    from pysolvers_tpu.sparse import DiaMatrix
    from pysolvers_tpu.utils.platform import warmup_device

    warmup_device()
    m = args.m
    H = pst.problems.fd_laplacian_2d(m, dtype=np.float32)
    A = DiaMatrix.from_host_csr(H)
    n = H.shape[0]
    rng = np.random.default_rng(0)

    def per_iter_cost(k_rhs, short=40, long=200, reps=3):
        B = jnp.asarray(rng.random((n, k_rhs)).astype(np.float32))
        # tau=0 => exactly maxiter iterations per column, no convergence
        # exits to blur the count
        fns = {it: jax.jit(lambda Bv, it=it: cg_solve_multi(
            lambda V: matmat(A, V), Bv, maxiter=it, tau=0.0)[0])
            for it in (short, long)}
        for f in fns.values():                     # compile
            float(f(B)[0, 0])
        best = {}
        for it, f in fns.items():
            b = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                float(f(B)[0, 0])                  # forces the fetch
                b = min(b, time.perf_counter() - t0)
            best[it] = b
        return max((best[long] - best[short]) / (long - short), 1e-9)

    c1 = per_iter_cost(1)
    ck = per_iter_cost(args.k)
    recs = [{
        "metric": "multi_rhs_cg_amortization",
        "m": m, "n": n, "k": args.k,
        "per_iter_single_s": round(c1, 8),
        "per_iter_blocked_s": round(ck, 8),
        # cost of one blocked iteration vs k single iterations
        "amortization_x": round(args.k * c1 / ck, 3),
        "backend": jax.default_backend(),
    }]

    # GMRES-multi amortization (round 3): the lockstep Arnoldi makes one
    # SpMM pass per step, but GMRES adds O(k_step·n) MGS work per column,
    # so the ratio is below CG's — the SpMM+dispatch savings still win
    from pysolvers_tpu.linear.krylov import gmres_solve_multi

    def gm_per_iter(k_rhs, short=20, long=60, reps=3, restart=None):
        B = jnp.asarray(rng.random((n, k_rhs)).astype(np.float32))
        fns = {it: jax.jit(lambda Bv, it=it: gmres_solve_multi(
            lambda V: matmat(A, V), Bv, maxiter=it, tau=0.0,
            restart=restart)[0])
            for it in (short, long)}
        for f in fns.values():
            float(f(B)[0, 0])
        best = {}
        for it, f in fns.items():
            b = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                float(f(B)[0, 0])
                b = min(b, time.perf_counter() - t0)
            best[it] = b
        return max((best[long] - best[short]) / (long - short), 1e-9)

    g1 = gm_per_iter(1)
    gk = gm_per_iter(args.k)
    recs.append({
        "metric": "multi_rhs_gmres_amortization",
        "m": m, "n": n, "k": args.k,
        "per_iter_single_s": round(g1, 8),
        "per_iter_blocked_s": round(gk, 8),
        "amortization_x": round(args.k * g1 / gk, 3),
        "backend": jax.default_backend(),
    })

    # RESTARTED lockstep (VERDICT r3 item 6): restart>0 stays blocked —
    # per-cycle basis reset + true-residual verify included in the cost
    gr1 = gm_per_iter(1, short=30, long=90, restart=25)
    grk = gm_per_iter(args.k, short=30, long=90, restart=25)
    recs.append({
        "metric": "multi_rhs_gmres_restarted_amortization",
        "m": m, "n": n, "k": args.k, "restart": 25,
        "per_iter_single_s": round(gr1, 8),
        "per_iter_blocked_s": round(grk, 8),
        "amortization_x": round(args.k * gr1 / grk, 3),
        "backend": jax.default_backend(),
    })
    # CONVERGED mixed multi at tau=1e-10 (round 5): solve(A, B,
    # precision='mixed') rides ONE continuous lockstep-rr pass
    # (krylov.cg_lockstep_rr, columns layout) — against k sequential
    # single-RHS mixed solves on the same warm caches
    jax.config.update("jax_enable_x64", True)
    H64 = pst.problems.fd_laplacian_2d(m, dtype=np.float64)
    X_true = rng.random((n, args.k))
    B64 = np.stack([H64.matvec(X_true[:, j]) for j in range(args.k)],
                   axis=1)
    kwargs = dict(tau=1e-10, maxiter=30000, precond="jacobi",
                  precision="mixed")
    st1 = pst.solve(H64, B64[:, 0], **kwargs)          # warm caches
    t0 = time.perf_counter()
    for j in range(args.k):
        st1 = pst.solve(H64, B64[:, j], **kwargs)
    t_seq = time.perf_counter() - t0
    stm = pst.solve(H64, B64, **kwargs)                # compile
    t0 = time.perf_counter()
    stm = pst.solve(H64, B64, **kwargs)
    t_blk = time.perf_counter() - t0
    Xm = np.asarray(stm.soln)
    col_resids = [float(np.linalg.norm(B64[:, j] - H64.matvec(Xm[:, j]))
                        / np.linalg.norm(B64[:, j]))
                  for j in range(args.k)]
    recs.append({
        "metric": "multi_rhs_mixed_converged_1e-10",
        "m": m, "n": n, "k": args.k,
        "t_sequential_s": round(t_seq, 3),
        "t_blocked_s": round(t_blk, 3),
        "amortization_at_tol": round(t_seq / t_blk, 3),
        "iters_blocked": int(stm.iters), "success": bool(stm.success),
        "max_col_rel_resid": max(col_resids),
        "backend": jax.default_backend(),
    })
    for rec in recs:
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
