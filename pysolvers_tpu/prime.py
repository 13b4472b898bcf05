"""Persistent-compile-cache priming (VERDICT r3 item 5).

A solver service cold-starting on a fresh machine pays the framework's
big first-compiles once: the GMG setup and the one-dispatch dd-chain
solve graphs.  ``prime_cache`` compiles exactly those graphs into JAX's
persistent compilation cache ahead of time — run it at deploy/install
(or in the background while data loads) and the first real solve hits
the disk cache instead of the compiler.

Cache keys depend on traced shapes and static arguments, so priming
must mirror the real configuration: same problem size ``m``, same
``levels``, same ``inner_maxiter``.  The defaults mirror the large
structured battery (benchmarks/run_large.py); the preconditioner apply
functions are shared library objects (gmg_grid.grid_vc_apply), so the
primed trace is bit-identical to the battery's.

CLI::

    python -m pysolvers_tpu.prime --m 1023 --configs cg,mg,vcycle

The reference has no compile step (eager numpy/SuperLU); this is the
compiled analog of shipping pre-built factorization plans.  The cache
lives where ``utils.platform.enable_persistent_cache`` puts it.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np


def prime_cache(m: int = 1023, levels: Optional[int] = None,
                configs=("cg", "mg", "vcycle"), cg_maxiter: int = 6000,
                verbose: bool = True) -> dict:
    """Compile the large-battery solve/setup graphs into the persistent
    cache.  Returns per-stage wall times (seconds).

    ``m``: grid side (n = m²) — must match the production problem size
    (compiled graphs are shape-keyed).  ``configs``: any of "cg"
    (unpreconditioned dd-chain), "mg" (PCG + 2-cycle grid GMG),
    "vcycle" (Richardson + 1-cycle GMG).
    """
    import jax
    jax.config.update("jax_enable_x64", True)
    import pysolvers_tpu as pst
    from .linear.gmg_grid import build_grid_hierarchy, grid_vc_apply
    from .linear.refine import ir_solve_dd
    from .sparse.device import DiaMatrix
    from .utils.platform import enable_persistent_cache, warmup_device

    enable_persistent_cache()

    def _log(msg):
        if verbose:
            print(f"[prime] {msg}", flush=True)

    times = {}
    t_all = time.perf_counter()
    warmup_device()

    t0 = time.perf_counter()
    H = pst.problems.fd_laplacian_2d(m, dtype=np.float64)
    H32 = pst.HostCSR(H.indptr, H.indices, H.data.astype(np.float32),
                      H.shape)
    b = H.matvec(np.ones(H.shape[0]))
    times["assemble_s"] = time.perf_counter() - t0
    _log(f"synthetic Lap2D(m={m}) assembled in {times['assemble_s']:.1f}s")

    t0 = time.perf_counter()
    A32 = DiaMatrix.from_host_csr(H32)
    A64 = DiaMatrix.from_host_csr(H)
    jax.block_until_ready(A32.diags)
    jax.block_until_ready(A64.diags)
    times["operator_s"] = time.perf_counter() - t0

    hier = None
    if "mg" in configs or "vcycle" in configs:
        if levels is None:
            lev, mm = 1, m
            while mm > 31 and mm % 2 == 1:
                mm = (mm - 1) // 2
                lev += 1
            levels = lev
        t0 = time.perf_counter()
        hier = build_grid_hierarchy(H, num_levels=levels, dims=(m, m),
                                    smoother="jacobi", dtype=np.float32)
        jax.block_until_ready(jax.tree_util.tree_leaves(hier))
        times["gmg_setup_s"] = time.perf_counter() - t0
        _log(f"GMG hierarchy ({levels} levels) built in "
             f"{times['gmg_setup_s']:.1f}s")

    # solve graphs: tau is a TRACED argument, so priming at a loose
    # tolerance compiles the same graph the 1e-10 production solve uses;
    # max_outer=1 bounds the host loop to one dispatch
    def _prime_solve(tag, method, pp, inner_maxiter, chain):
        t0 = time.perf_counter()
        ir_solve_dd(H.matvec, b, A_lo=A32, A64=A64, tau=1e-2,
                    inner_tau=1e-2, inner_maxiter=inner_maxiter,
                    method=method, precond_pair=pp, chain=chain,
                    max_outer=1)
        times[f"{tag}_s"] = time.perf_counter() - t0
        _log(f"{tag} solve graph compiled in {times[f'{tag}_s']:.1f}s")

    if "cg" in configs:
        _prime_solve("cg", "cg", None, cg_maxiter, 2)
    if "mg" in configs:
        _prime_solve("mg", "cg", (grid_vc_apply(2), hier), 100, 4)
    if "vcycle" in configs:
        _prime_solve("vcycle", "richardson", (grid_vc_apply(1), hier),
                     100, 4)

    times["total_s"] = time.perf_counter() - t_all
    _log(f"done in {times['total_s']:.1f}s")
    return times


def main():
    import argparse
    ap = argparse.ArgumentParser(
        description="Prime the persistent compile cache for the "
                    "large-problem solve graphs.")
    ap.add_argument("--m", type=int, default=1023)
    ap.add_argument("--levels", type=int, default=None)
    ap.add_argument("--configs", default="cg,mg,vcycle")
    ap.add_argument("--cg-maxiter", type=int, default=6000)
    args = ap.parse_args()
    prime_cache(args.m, args.levels,
                tuple(args.configs.split(",")), args.cg_maxiter)


if __name__ == "__main__":
    main()
