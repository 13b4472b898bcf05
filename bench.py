#!/usr/bin/env python
"""Headline benchmark: SpMV throughput (nnz/s) on the default JAX device on
the reference's own problem family (2D FD Laplacian).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

vs_baseline compares against the reference's compute engine for the same op
on this host: scipy.sparse CSR SpMV (the C kernel PySolvers delegates every
matvec to — reference PySolvers/Linear/IterativeLinearSolver.py:103-106).
"""
import json
import time

import numpy as np


def bench_device_spmv(m_small=1448, m_large=2047, reps=4):
    """Marginal-cost timing: two in-jit SpMV chains of different lengths,
    per-iteration time = (t_long - t_short) / (n_long - n_short).

    Fixed dispatch/sync overhead cancels, results are data-chained so
    nothing can be served from a cache, and a scalar fetch forces real
    completion.  The operator rides as a jit ARGUMENT — the real solver
    configuration (PCGSolver passes the matrix into its compiled solve).

    Two sizes are measured (m_small: a 42 MB diagonal table; m_large:
    84 MB), with the streaming peak (triad a + 0.5·b over 64M floats,
    same marginal method, same process) as the measured roofline.
    """
    import jax
    import jax.numpy as jnp
    import pysolvers_tpu as pst
    from pysolvers_tpu.utils.platform import enable_persistent_cache
    enable_persistent_cache()

    def marginal(make_chain, v0, n_short, n_long, *args):
        c_short, c_long = make_chain(n_short), make_chain(n_long)
        _ = float(c_short(*args, v0)[0])      # compile
        _ = float(c_long(*args, v0)[0])

        def timed(fn, v):
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                v = fn(*args, v)
                _ = float(v[0])          # force completion
                best = min(best, time.perf_counter() - t0)
            return best, v

        t_short, y = timed(c_short, v0)
        t_long, _ = timed(c_long, y)
        return max((t_long - t_short) / (n_long - n_short), 1e-9)

    def make_spmv_chain(iters):
        @jax.jit
        def chain(A, v):
            return jax.lax.fori_loop(0, iters,
                                     lambda _, v: pst.matvec(A, v), v)
        return chain

    def spmv_rate(m):
        H = pst.problems.fd_laplacian_2d(m, dtype=np.float32)
        # bake the boundedness scale into the matrix values ONCE (abs row
        # sums become ~1, so chained f32 iterates stay finite) — both
        # sides then time a bare SpMV per iteration, no elementwise pass
        H.data *= np.float32(1.0 / (8.0 * (m + 1.0) ** 2))
        A = pst.DiaMatrix.from_host_csr(H)
        x = jnp.asarray(np.random.default_rng(0).random(m * m)
                        .astype(np.float32))
        per_iter = marginal(make_spmv_chain, x, 50, 250, A)
        # two traffic models for one DIA SpMV:
        #  * stream model (diags + x + y) — what a cache-less pass moves;
        #  * matrix-only (diags) — a strict lower bound on the streamed
        #    bytes, so the roofline percentage can never overcount.
        n = m * m
        D = len(A.offsets)
        gbs_stream = (D * n + 2 * n) * 4 / per_iter / 1e9
        gbs_matrix = D * n * 4 / per_iter / 1e9
        return H.nnz / per_iter, gbs_stream, gbs_matrix

    small_nnzs, _, _ = spmv_rate(m_small)
    large_nnzs, large_gbs, large_gbs_min = spmv_rate(m_large)

    # measured streaming roofline: triad (2 reads + 1 write)
    import numpy as _np
    nb = 64_000_000
    big = jnp.asarray(_np.random.default_rng(1).random(nb).astype(
        _np.float32))
    big2 = jnp.asarray(_np.random.default_rng(2).random(nb).astype(
        _np.float32))

    def make_triad_chain(iters):
        @jax.jit
        def chain(b2, v):
            return jax.lax.fori_loop(0, iters,
                                     lambda _, v: v + 0.5 * b2, v)
        return chain

    per_triad = marginal(make_triad_chain, big, 5, 25, big2)
    peak_gbs = nb * 4 * 3 / per_triad / 1e9

    return dict(device_nnzs=small_nnzs, large_nnzs=large_nnzs,
                large_gbs=large_gbs, large_gbs_min=large_gbs_min,
                peak_gbs=peak_gbs)


def bench_scipy_spmv(m=1448, iters=20):
    import scipy.sparse as sp
    import pysolvers_tpu as pst

    # the SAME operator the device side measures (one definition) with the
    # SAME baked-in boundedness scale (without it the chained f32
    # iterates overflow to inf within ~6 iterations and the baseline
    # times non-finite arithmetic instead of SpMV); neither side pays a
    # per-iteration elementwise pass
    H = pst.problems.fd_laplacian_2d(m, dtype=np.float32)
    H.data *= np.float32(1.0 / (8.0 * (m + 1.0) ** 2))
    A = sp.csr_matrix((H.data, H.indices, H.indptr), shape=H.shape)
    x = np.random.default_rng(0).random(m * m).astype(np.float32)
    y = A @ x
    t0 = time.perf_counter()
    for _ in range(iters):
        y = A @ y
    dt = (time.perf_counter() - t0) / iters
    return A.nnz / dt


def main():
    import jax

    # one process: the device-touching part runs here, on the one card
    dev = jax.devices()[0]
    rec = bench_device_spmv()
    ref_nnzs = bench_scipy_spmv()
    print(json.dumps({
        "metric": "spmv_nnz_per_s_fd_laplacian2d",
        "value": round(rec["device_nnzs"] / 1e9, 4),
        "unit": "Gnnz/s",
        "vs_baseline": round(rec["device_nnzs"] / ref_nnzs, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "large": {
            "m": 2047,
            "gnnzs": round(rec["large_nnzs"] / 1e9, 4),
            "effective_gbs_stream_model": round(rec["large_gbs"], 1),
            "matrix_stream_gbs": round(rec["large_gbs_min"], 1),
            "pct_of_measured_triad_peak_lower_bound": round(
                100.0 * rec["large_gbs_min"] / rec["peak_gbs"], 1),
        },
        "peak_gbs_measured": round(rec["peak_gbs"], 1),
    }))


if __name__ == "__main__":
    main()
