"""Unstructured SA-AMG at n >= 1M, end to end on the device.

The reference's production multigrid is smoothed-aggregation AMG over
unstructured FEM matrices (/root/reference PySolvers/Linear/
SmoothedAggregation.py:185-205, MLHierarchy.py:50-54), demonstrated there
only up to DH-15 (n=16.6k).  This driver runs the same *algebraic*
pipeline at n >= 1e6 on a genuine unstructured problem (jittered-
triangulation P1 FEM, random node numbering — problems/fem.py):

  1. RCM reorder (native C++) — the unstructured-pipeline normalization;
  2. host SA setup: strength/aggregation (C++), smoothed prolongator and
     Galerkin R·A·P via the C++ Gustavson SpGEMM — the measured scalable
     host path;
  3. device lowering: every level operator and transfer as DIA/ELL;
     coarsest level inverted on the host, applied on device;
  4. PCG + AMG(num_iters) preconditioner, mixed precision (f32 kernels,
     f64 refinement) to tau=1e-10 — against plain CG at the same tau.

Writes one JSON line per row to --out (benchmarks/our_results/*.jsonl).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pysolvers_tpu.sparse.host import HostCSR  # noqa: E402


def load_problem(m: int, seed: int, cache_dir: str):
    """Generate (or load cached) unstructured FEM matrix + RCM perm."""
    from pysolvers_tpu.problems.fem import fem_poisson_2d_unstructured

    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"fem_m{m}_s{seed}.npz")
    t0 = time.time()
    if os.path.exists(path):
        d = np.load(path)
        A = HostCSR(d["indptr"], d["indices"], d["data"], tuple(d["shape"]))
        gen_s = 0.0
    else:
        A = fem_poisson_2d_unstructured(m, seed=seed)
        np.savez(path, indptr=A.indptr, indices=A.indices, data=A.data,
                 shape=np.array(A.shape))
        gen_s = time.time() - t0
    t0 = time.time()
    perm = A.rcm_perm()
    rcm_s = time.time() - t0
    t0 = time.time()
    Ap = A.permute_symmetric(perm)
    return Ap, gen_s, rcm_s, time.time() - t0


def run(m: int, seed: int, tau: float, levels: int, num_iters: int,
        maxiter_cg: int, runs: int, cache_dir: str, only: str = ""):
    import jax
    jax.config.update("jax_enable_x64", True)
    from pysolvers_tpu.utils.platform import enable_persistent_cache
    enable_persistent_cache()

    from pysolvers_tpu.api import PCG, CommonSolverArgs
    from pysolvers_tpu.linear.amg import AMGPreconditionerType

    Ap, gen_s, rcm_s, permute_s = load_problem(m, seed, cache_dir)
    reorder_s = rcm_s + permute_s
    n, nnz = Ap.shape[0], Ap.nnz
    rng = np.random.default_rng(7)
    x_true = rng.normal(size=n)
    b = Ap.matvec(x_true)

    rows = []

    def one_solve(tag, precond, warm=False, **kw):
        from pysolvers_tpu.utils.timing import Timer
        control = CommonSolverArgs(maxiter=maxiter_cg, tau=tau)
        results = []
        for r in range(runs):
            Timer.reset()
            solver = PCG(control, precond=precond() if precond else None,
                         precision="mixed").make_solver()
            t0 = time.time()
            st = solver.solve(Ap, b)
            wall = time.time() - t0
            err = float(np.abs(np.asarray(st.soln, dtype=np.float64)
                               - x_true).max() / np.abs(x_true).max())
            results.append(dict(wall_s=wall, iters=int(st.iters),
                                resid=float(st.resid), err=err,
                                success=bool(st.success)))
            print(f"  [{tag} run {r}] {wall:.2f}s iters={st.iters} "
                  f"resid={float(st.resid):.3e} err={err:.3e} "
                  f"success={st.success}", flush=True)
            Timer.report()
        walls = sorted(x["wall_s"] for x in results)
        med = results[[x["wall_s"] for x in results].index(
            walls[len(walls) // 2])]
        row = dict(tag=tag, n=n, nnz=nnz, tau=tau, backend=str(
            jax.default_backend()), runs=runs,
            wall_s=walls[len(walls) // 2],
            wall_range=[walls[0], walls[-1]], **{
                k: med[k] for k in ("iters", "resid", "err", "success")},
            gen_s=gen_s, reorder_s=reorder_s, rcm_s=rcm_s,
            permute_s=permute_s)
        rows.append(row)
        return row

    print(f"n={n} nnz={nnz} (reorder {reorder_s:.1f}s = "
          f"rcm {rcm_s:.1f} + permute {permute_s:.1f})", flush=True)
    amg = lambda: AMGPreconditionerType(  # noqa: E731
        num_iters=num_iters, num_levels=levels, galerkin="host")
    # ``only``: comma list of row groups ("samg", "cg", "reuse")
    sel = set(only.split(",")) if only else {"samg", "cg", "reuse"}
    if "samg" in sel:
        one_solve(f"pcg_samg_l{levels}i{num_iters}", amg)
    if "cg" in sel:
        one_solve("plain_cg", None)
    if "reuse" not in sel:
        return rows

    # hierarchy REUSE (VERDICT r4 item 3b — freezeMatrix semantics,
    # reference LinearSolver.py:35-42): ONE solver, one setup, then
    # n_reuse fresh right-hand sides re-solved against the frozen
    # operator/preconditioner.  setup_s = first-solve wall minus the
    # median re-solve wall (the first call pays hierarchy build + pack
    # + compile; later calls only the Krylov loop).
    control = CommonSolverArgs(maxiter=maxiter_cg, tau=tau)
    solver = PCG(control, precond=amg(), precision="mixed").make_solver()
    t0 = time.time()
    st0 = solver.solve(Ap, b)
    first_s = time.time() - t0
    re_walls, re_iters = [], []
    n_reuse = 8
    for j in range(n_reuse):
        bj = Ap.matvec(rng.normal(size=n))
        t0 = time.time()
        stj = solver.solve(Ap, bj)
        re_walls.append(time.time() - t0)
        re_iters.append(int(stj.iters))
        print(f"  [reuse {j}] {re_walls[-1]:.2f}s iters={stj.iters} "
              f"success={stj.success}", flush=True)
    re_walls_s = sorted(re_walls)
    med_re = re_walls_s[len(re_walls_s) // 2]
    row = dict(tag=f"pcg_samg_reuse_k{n_reuse}", n=n, nnz=nnz, tau=tau,
               backend=str(jax.default_backend()),
               first_solve_s=round(first_s, 2),
               resolve_s=round(med_re, 2),
               resolve_range=[round(re_walls_s[0], 2),
                              round(re_walls_s[-1], 2)],
               setup_s=round(first_s - med_re, 2),
               iters=int(np.median(re_iters)),
               success=bool(st0.success),
               gen_s=gen_s, reorder_s=reorder_s, rcm_s=rcm_s,
               permute_s=permute_s)
    rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=1025)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--tau", type=float, default=1e-10)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--num-iters", type=int, default=2)
    ap.add_argument("--maxiter", type=int, default=20000)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--cache", default=os.path.join(
        os.path.dirname(__file__), "data"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", default="",
                    help="comma list of row groups: samg,cg,reuse")
    args = ap.parse_args()
    rows = run(args.m, args.seed, args.tau, args.levels, args.num_iters,
               args.maxiter, args.runs, args.cache, only=args.only)
    for row in rows:
        line = json.dumps(row, default=float)
        print(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
