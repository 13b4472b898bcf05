#!/usr/bin/env python
"""Large structured-problem head-to-head: 2-D FD Laplacian at n = m².

The DH suite tops out at n=16,641 (lev 15; lev 16 is stripped from the
reference repo).  This runner scales the reference's other problem
family (examples/FDLaplacian2D.py:5-23) to 10^5-10^6+ unknowns, where
per-chip throughput, not dispatch latency, decides the outcome.

Configs (τ=1e-10 relative residual, manufactured solution):
  cg   unpreconditioned CG — identical algorithm both sides
  mg   multigrid-preconditioned CG (2 cycles/apply):
         ours      = gather-free structured-grid GMG (linear/gmg_grid.py:
                     DIA stencil levels + strided-slice transfers),
                     Jacobi(2/3) smoothers
         reference = SA-AMG preconditioner (PCGExample_AMG.py:20-22
                     pattern) at the numLevels that keeps its per-cycle
                     coarse spsolve small; its default GS smoother
  vcycle  multigrid as the SOLVER (reference VCycleExample.py:22-25
         pattern, same hierarchies as mg)

Sides:
  --side ours       the default JAX device (or --platform cpu) via the
                    mixed-precision dd-chain
                    refinement (f32 kernels, f64-grade answers)
  --side reference  /root/reference PySolvers on this host's CPU.
                    The reference assembles by Python DOK loop (minutes
                    at n=10^6, before any solving); we hand it the SAME
                    matrix assembled vectorized so the measurement is
                    solver time, not its assembly loop.

Ours accounting: time_s = setup_s (warm, full
re-setup) + solve_s (steady state); setup_cold_s / compile_s reported
separately.  The reference has no compile/warm distinction: time_s is
its single-shot wall clock (setup inside).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _mg_levels(m: int) -> int:
    """Levels so the coarsest grid is ~31×31 (dense-invertible, and the
    reference's per-cycle coarse spsolve stays trivial)."""
    lev = 1
    while m > 31 and m % 2 == 1:
        m = (m - 1) // 2
        lev += 1
    return lev


# apply fns come from the library registry (gmg_grid.grid_vc_apply):
# stable identity keys refine's jit caches, and sharing the very same
# functions with pysolvers_tpu.prime makes cache priming hit


def run_ours(args, emit):
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    jax.config.update("jax_enable_x64", True)
    from pysolvers_tpu.utils.platform import enable_persistent_cache
    enable_persistent_cache()
    import jax.numpy as jnp
    import pysolvers_tpu as pst
    from pysolvers_tpu.linear.gmg_grid import (build_grid_hierarchy,
                                               grid_vc_apply)
    from pysolvers_tpu.linear.refine import ir_solve_dd
    from pysolvers_tpu.sparse.device import DiaMatrix
    from pysolvers_tpu.utils.platform import warmup_device

    _vc1, _vc2 = grid_vc_apply(1), grid_vc_apply(2)
    m = args.m
    n = m * m
    H = pst.problems.fd_laplacian_2d(m, dtype=np.float64)
    rng = np.random.default_rng(0)
    x_exact = rng.random(n)
    b = H.matvec(x_exact)
    b_norm = np.linalg.norm(b)
    levels = args.levels or _mg_levels(m)
    warmup_device()

    H32 = pst.HostCSR(H.indptr, H.indices, H.data.astype(np.float32),
                      H.shape)

    _dbg = os.environ.get("PST_DEBUG_SETUP") == "1"

    def _mark(label, t0):
        if _dbg:
            print(f"    [setup] {label}: "
                  f"{time.perf_counter() - t0:.3f}s", flush=True)
        return time.perf_counter()

    def setup_operator():
        t = time.perf_counter()
        A32 = DiaMatrix.from_host_csr(H32)
        A64 = DiaMatrix.from_host_csr(H)
        t = _mark("dia_build", t)
        jax.block_until_ready(A32.diags)
        jax.block_until_ready(A64.diags)
        _mark("dia_block", t)
        return A32, A64

    def setup_mg():
        A32, A64 = setup_operator()
        t = time.perf_counter()
        hier = build_grid_hierarchy(H, num_levels=levels, dims=(m, m),
                                    smoother="jacobi", dtype=np.float32)
        t = _mark("hier_build", t)
        jax.block_until_ready(jax.tree_util.tree_leaves(hier))
        _mark("hier_block", t)
        return A32, A64, hier

    def run(config, make_fn, solve_fn):
        t0 = time.perf_counter()
        make_fn()
        setup_cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        state = make_fn()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        solve_fn(state)
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        iters, rel, ok = solve_fn(state)
        solve_s = time.perf_counter() - t0
        emit(dict(config=config, n=n, time_s=round(setup_s + solve_s, 6),
                  setup_s=round(setup_s, 6),
                  setup_cold_s=round(setup_cold_s, 6),
                  solve_s=round(solve_s, 6), iters=int(iters),
                  rel_resid=float(rel), success=bool(ok),
                  compile_s=round(max(compile_s - solve_s, 0.0), 3)))

    def mk_solve(method, precond_pair=None, inner_maxiter=200, chain=4,
                 max_outer=40):
        def solve(state):
            if precond_pair is None:
                A32, A64 = state
                pp = None
            else:
                A32, A64, hier = state
                pp = (precond_pair, hier)
            x, st, _ = ir_solve_dd(
                H.matvec, b, A_lo=A32, A64=A64, tau=1e-10,
                inner_tau=1e-6, inner_maxiter=inner_maxiter,
                method=method, precond_pair=pp, chain=chain,
                max_outer=max_outer)
            return int(st.k), float(st.resid) / b_norm, int(st.reason) == 1
        return solve

    want = set(args.configs.split(","))
    if "cg" in want:
        run(f"Lap2D(m={m})+CG", setup_operator,
            mk_solve("cg", inner_maxiter=args.cg_maxiter, chain=2,
                     max_outer=16))
    if "mg" in want:
        run(f"Lap2D(m={m})+PCG+GMG{levels}(grid)", setup_mg,
            mk_solve("cg", precond_pair=_vc2, inner_maxiter=100))
    if "vcycle" in want:
        run(f"Lap2D(m={m})+VCycleSolver+GMG{levels}(grid)", setup_mg,
            mk_solve("richardson", precond_pair=_vc1,
                     inner_maxiter=100))
    if "mg_reuse" in want:
        # setup amortization: ONE hierarchy (freeze semantics, reference
        # LinearSolver.py:35-42), k solves with distinct right-hand
        # sides — the regime a Newton sequence or a solver service pays
        k_solves = 8
        state = setup_mg()                    # includes compile warmup
        solve1 = mk_solve("cg", precond_pair=_vc2, inner_maxiter=100)
        solve1(state)                         # compile
        t0 = time.perf_counter()
        state = setup_mg()
        setup_s = time.perf_counter() - t0
        per, its_tot = [], 0
        rng2 = np.random.default_rng(7)
        for j in range(k_solves):
            bj = H.matvec(rng2.random(n))
            t0 = time.perf_counter()
            x, st, _ = ir_solve_dd(H.matvec, bj, A_lo=state[0],
                                   A64=state[1], tau=1e-10,
                                   inner_maxiter=100, method="cg",
                                   precond_pair=(_vc2, state[2]))
            per.append(time.perf_counter() - t0)
            its_tot += int(st.k)
        per_s = float(np.median(per))
        emit(dict(config=f"Lap2D(m={m})+PCG+GMG{levels} reuse x{k_solves}",
                  n=n, time_s=round(setup_s + sum(per), 6),
                  setup_s=round(setup_s, 6),
                  per_solve_s=round(per_s, 6),
                  per_solve_min=round(min(per), 6),
                  per_solve_max=round(max(per), 6),
                  solves=k_solves, iters=its_tot, success=True))


def run_reference(args, emit):
    from run_reference import _make_stubs  # stub PyTab/PyTimer deps
    _make_stubs()
    from run_reference import STUBS
    sys.path.insert(0, STUBS)
    sys.path.insert(0, "/root/reference")
    import scipy.sparse as sp
    import numpy.linalg as npla
    from PySolvers import CommonSolverArgs
    from PySolvers.Linear import PCG, AMG, AMGVCycle

    m = args.m
    n = m * m
    levels = args.levels or _mg_levels(m)
    # the reference's own operator values (FDLaplacian2D.py:5-23, negated
    # for SPD like run_reference.py's 1-D config) assembled vectorized —
    # its DOK double loop costs minutes at n=10^6 and measures nothing
    # about the solvers
    h2 = (m + 1.0) ** 2
    main = np.full(n, 4.0 * h2)
    ew = np.full(n - 1, -h2)
    ew[np.arange(1, n) % m == 0] = 0.0   # row breaks
    ns = np.full(n - m, -h2)
    A = sp.diags([main, ew, ew, ns, ns], [0, 1, -1, m, -m]).tocsr()
    rng = np.random.default_rng(0)
    x_exact = rng.random(n)
    b = A @ x_exact
    b_norm = npla.norm(b)

    def run(config, fn):
        t0 = time.perf_counter()
        iters, rel, ok = fn()
        emit(dict(config=config, n=n,
                  time_s=round(time.perf_counter() - t0, 6),
                  iters=int(iters), rel_resid=float(rel),
                  success=bool(ok)))

    def finish(r):
        rel = (npla.norm(b - A @ r.soln()) / b_norm if r.success()
               else np.inf)
        return r.iters(), rel, r.success()

    want = set(args.configs.split(","))
    if "cg" in want:
        def cg():
            s = PCG(control=CommonSolverArgs(maxiter=args.cg_maxiter,
                                             tau=1e-10)).makeSolver()
            return finish(s.solve(A, b))
        run(f"Lap2D(m={m})+CG", cg)
    if "mg" in want:
        def mg():
            s = PCG(control=CommonSolverArgs(maxiter=500, tau=1e-10),
                    precond=AMG(numIters=2, numLevels=levels)).makeSolver()
            return finish(s.solve(A, b))
        run(f"Lap2D(m={m})+PCG+AMG{levels}", mg)
    if "vcycle" in want:
        def vc():
            s = AMGVCycle(control=CommonSolverArgs(maxiter=200, tau=1e-10),
                          numLevels=levels).makeSolver()
            return finish(s.solve(A, b))
        run(f"Lap2D(m={m})+VCycleSolver+AMG{levels}", vc)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", choices=["ours", "reference"],
                    default="ours")
    ap.add_argument("--m", type=int, default=1023,
                    help="interior grid points per side (2^k-1 for mg)")
    ap.add_argument("--levels", type=int, default=None)
    ap.add_argument("--configs", default="cg,mg,vcycle")
    ap.add_argument("--cg-maxiter", type=int, default=6000)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    results = []

    def emit(rec):
        rec["side"] = args.side
        results.append(rec)
        print(json.dumps(rec), flush=True)

    if args.side == "ours":
        run_ours(args, emit)
    else:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        run_reference(args, emit)

    if args.out:
        with open(args.out, "a") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
