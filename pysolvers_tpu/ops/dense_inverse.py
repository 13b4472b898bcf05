"""Dense matrix inverse ON DEVICE (Gauss-Jordan, no pivoting).

Inverts an operator that already lives on the device without a host
round trip and without ``jnp.linalg`` custom calls: pivot-free blocked
Gauss-Jordan elimination — fine for the SPD/diagonally-dominant coarse
operators AMG/GMG produce (growth is Cholesky-like), all dense matmul work
at HIGHEST precision.  Used by the device-probed GMG build
(linear/gmg_grid.py) and the device SA setup (parallel/amg_setup.py); the
host-built hierarchies invert on the host with LAPACK.

A setup-phase cost: n iterations × O(n²) traffic.  Not a general-purpose
LU (no pivoting): use only on matrices known positive-definite-ish.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


from functools import partial


@partial(jax.jit, static_argnums=(3, 4))
def dense_inverse_from_coo(rows, cols, vals, n: int, dtype_name: str):
    """Scatter a sparse COO operator to dense and invert it in ONE jitted
    dispatch (only the compact COO streams ship)."""
    return inv_from_coo_build((rows, cols, vals), (n, dtype_name))


def inv_from_coo_build(arrs, st):
    """ops/fuse.py builder form of ``dense_inverse_from_coo`` (stable
    module-level identity keys the fused-setup jit cache)."""
    rows, cols, vals = arrs
    n, dtype_name = st
    dtype = jnp.dtype(dtype_name)
    # .add, not .set: COO semantics sum duplicate coordinates (as
    # HostCSR.from_coo does) — .set would silently keep an arbitrary one
    M = jnp.zeros((n, n), dtype=dtype).at[rows, cols].add(
        vals.astype(dtype))
    return dense_inverse(M)


def dense_inverse(M: jax.Array, panel: int = 128) -> jax.Array:
    """Return M^{-1} for square SPD-ish M (jittable, device-only).

    BLOCKED pivot-free Gauss-Jordan: each step eliminates a ``panel``-wide
    column block from every row with two matmuls (a rank-1 version
    streams the whole (n, 2n) tableau n times; the blocked version
    streams it n/panel times).  Same no-pivot assumption: principal
    blocks of an SPD-ish matrix stay invertible."""
    n = M.shape[0]
    dtype = M.dtype
    if n <= panel:
        return _gj_small(M)
    npad = ((n + panel - 1) // panel) * panel
    if npad != n:
        # identity tail: inv(blockdiag(M, I)) = blockdiag(inv(M), I)
        Mp = jnp.zeros((npad, npad), dtype=dtype).at[:n, :n].set(M)
        tail = jnp.arange(n, npad)
        Mp = Mp.at[tail, tail].set(1.0)
    else:
        Mp = M
    X = jnp.concatenate([Mp, jnp.eye(npad, dtype=dtype)], axis=1)
    idx = jnp.arange(npad)

    def body(k, X):
        c0 = k * panel
        D = jax.lax.dynamic_slice(X, (c0, c0), (panel, panel))
        rows = jax.lax.dynamic_slice(X, (c0, 0), (panel, 2 * npad))
        R = jnp.dot(_gj_small(D), rows, precision=jax.lax.Precision.HIGHEST)
        C = jax.lax.dynamic_slice(X, (0, c0), (npad, panel))
        in_panel = (idx >= c0) & (idx < c0 + panel)
        C = jnp.where(in_panel[:, None], 0.0, C)
        X = X - jnp.dot(C, R, precision=jax.lax.Precision.HIGHEST)
        return jax.lax.dynamic_update_slice(X, R, (c0, 0))

    X = jax.lax.fori_loop(0, npad // panel, body, X)
    return X[:n, npad:npad + n]


def _gj_small(M: jax.Array) -> jax.Array:
    """Rank-1 pivot-free Gauss-Jordan for one small block (jittable)."""
    n = M.shape[0]
    X = jnp.concatenate([M, jnp.eye(n, dtype=M.dtype)], axis=1)  # (n, 2n)
    idx = jnp.arange(n)

    def body(k, X):
        row = jnp.take(X, k, axis=0)                 # (2n,)
        piv = jnp.take(row, k)
        row = row / piv
        col = jnp.take(X, k, axis=1)                 # (n,)
        col = jnp.where(idx == k, 0.0, col)          # don't eliminate row k
        X = X - col[:, None] * row[None, :]
        return X.at[k].set(row)

    X = jax.lax.fori_loop(0, n, body, X)
    return X[:, n:]
