"""Sparse matrix–vector product kernels (the framework's hottest op).

Replaces the reference's delegation to scipy's C CSR SpMV
(PySolvers/Linear/IterativeLinearSolver.py:94-106 ``mvmult``; used in every
solver hot loop, e.g. PCGSolver.py:111).

Every route is plain XLA, dispatched by matrix format:

1. ``DiaMatrix`` → shift-and-fma over static diagonal offsets: gather-free,
   bandwidth-bound at ~4·n_diags bytes per row in f32.  The path of FD
   stencils and of every structured multigrid level.

2. ``BdiaMatrix`` → the planar block-DIA shift-and-fma (``_bdia_xla``),
   one pass over the block planes for one or k right-hand sides.

3. ``EllMatrix`` → padded-ELL gather: correct for every dtype and any
   sparsity; the unstructured route and the distributed all-gather format.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.device import DiaMatrix, EllMatrix


# ---------------------------------------------------------------------------
# ELL: padded gather (every dtype)
# ---------------------------------------------------------------------------

def ell_spmv_xla(A: EllMatrix, x: jax.Array) -> jax.Array:
    """General SpMV via XLA gather; correct for every dtype and shape."""
    n = A.n_rows
    # +1 slot: padding columns use the sentinel index n_cols (zero there)
    xp = jnp.zeros((max(A.n_cols_pad, A.n_cols + 1),), dtype=x.dtype)
    xp = xp.at[: A.n_cols].set(x[: A.n_cols])
    g = jnp.take(xp, A.cols, axis=0)
    y = jnp.sum(A.data * g, axis=1)
    return y[:n]


def ell_spmv_f64(A: EllMatrix, x: jax.Array) -> jax.Array:
    """ELL SpMV gathered and accumulated in f64 whatever the table's
    dtype: the in-graph high-precision residual of the one-dispatch
    refinement chain (linear/refine.py::dd-chain).

    The gather is a plain f64 gather.  A hi/lo f32 split of x
    (x - f64(f32(x))) is not an option on the GPU: XLA's excess-precision
    simplification removes the f64→f32→f64 round trip, the lo part
    becomes zero and the "f64" residual is only f32-accurate."""
    n = A.n_rows
    xp = jnp.zeros((max(A.n_cols_pad, A.n_cols + 1),), jnp.float64)
    xp = xp.at[: A.n_cols].set(x[: A.n_cols].astype(jnp.float64))
    g = jnp.take(xp, A.cols, axis=0)
    return jnp.sum(A.data.astype(jnp.float64) * g, axis=1)[:n]


def ellt_spmv_f64(A, x: jax.Array) -> jax.Array:
    """``ell_spmv_f64`` on the SLOT-MAJOR layout (sparse.device.EllTMatrix):
    one flat 1-D gather per slot stream instead of an (n, k) gather."""
    n = A.n_rows
    xp = jnp.zeros((max(A.n_cols_pad, A.n_cols + 1),), jnp.float64)
    xp = xp.at[: A.n_cols].set(x[: A.n_cols].astype(jnp.float64))
    y = jnp.zeros((A.n_rows_pad,), jnp.float64)
    for s in range(A.k):
        y = y + A.data_t[s].astype(jnp.float64) * jnp.take(xp, A.cols_t[s])
    return y[:n]


# ---------------------------------------------------------------------------
# DIA: y = sum_d diag_d * shift(x, off_d)
# ---------------------------------------------------------------------------

def dia_spmv_xla(A: DiaMatrix, x: jax.Array) -> jax.Array:
    """Shift-and-fma SpMV in plain jnp (XLA fuses the static slices)."""
    n = A.n_rows
    n_cols = A.shape[1]
    n_pad = A.diags.shape[1]
    pad_lo = max(0, -min(A.offsets))
    # pad against x's length (= n_cols), NOT the row count: a tall
    # rectangular operator (e.g. a GMG prolongator) under-padded here and
    # dynamic_slice silently CLAMPED the out-of-bounds start (wrong values)
    pad_hi = max(0, max(0, max(A.offsets)) + n_pad - n_cols)
    xp = jnp.concatenate([
        jnp.zeros(pad_lo, x.dtype), x.astype(A.dtype),
        jnp.zeros(pad_hi, A.dtype)])
    acc = jnp.zeros(n_pad, dtype=jnp.result_type(A.dtype, x.dtype))
    for d, off in enumerate(A.offsets):
        acc = acc + A.diags[d] * jax.lax.dynamic_slice(
            xp, (off + pad_lo,), (n_pad,))
    return acc[:n]


# ---------------------------------------------------------------------------
# Planar block-DIA (sparse/bdia.py layout)
# ---------------------------------------------------------------------------

def _bdia_xla(A, xb: jax.Array):
    """(b, nb_pad[, k]) planar shift-and-FMA in plain jnp:
    y[p, i] = Σ_d Σ_q planes[d·b+q, p, i] · x[q, i + off_d]."""
    b = A.b
    pad_lo = max(0, -min(A.offsets))
    pad_hi = max(0, max(A.offsets))
    pad = [(0, 0), (pad_lo, pad_hi)] + [(0, 0)] * (xb.ndim - 2)
    xp = jnp.pad(xb, pad)
    acc = jnp.zeros_like(xb)
    for d, off in enumerate(A.offsets):
        start = (0, off + pad_lo) + (0,) * (xb.ndim - 2)
        xs = jax.lax.dynamic_slice(xp, start, xb.shape)
        for q in range(b):
            pl_dq = A.planes[d * b + q]          # (b, nb_pad)
            if xb.ndim == 3:
                pl_dq = pl_dq[..., None]
            acc = acc + pl_dq * xs[q:q + 1]
    return acc


def bdia_spmv(A, x: jax.Array) -> jax.Array:
    """Planar block-DIA SpMV.  x and y are PLANAR-ordered — reorder once
    per solve with BdiaMatrix.to_planar/from_planar."""
    b, nb = A.b, A.nb
    xb = jnp.zeros((b, A.nb_pad), dtype=jnp.result_type(A.dtype, x.dtype))
    xb = xb.at[:, :nb].set(x.astype(xb.dtype).reshape(b, nb))
    return _bdia_xla(A, xb)[:, :nb].reshape(b * nb)


def bdia_spmm_rows(A, V: jax.Array) -> jax.Array:
    """Lockstep planar block-DIA SpMM in ROW layout: V is (k, n) with
    one RHS per ROW.  Returns (k, n).  One pass over the block planes
    serves all k right-hand sides."""
    b, nb = A.b, A.nb
    k = V.shape[0]
    dt = jnp.result_type(A.dtype, V.dtype)
    xb0 = jnp.zeros((k, b, A.nb_pad), dtype=dt).at[:, :, :nb].set(
        V.astype(dt).reshape(k, b, nb))
    y = _bdia_xla(A, xb0.transpose(1, 2, 0))[:, :nb, :]   # (b, nb, k)
    return y.transpose(2, 0, 1).reshape(k, b * nb)


def bdia_spmm(A, X: jax.Array) -> jax.Array:
    """Blocked multi-RHS planar block-DIA SpMM: (n, k) -> (n, k), one
    pass over the block streams for all k columns (planar-ordered)."""
    b, nb = A.b, A.nb
    k = X.shape[1]
    xb = jnp.zeros((b, A.nb_pad, k),
                   dtype=jnp.result_type(A.dtype, X.dtype))
    xb = xb.at[:, :nb, :].set(X.astype(xb.dtype).reshape(b, nb, k))
    return _bdia_xla(A, xb)[:, :nb, :].reshape(b * nb, k)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def matvec(A, x: jax.Array) -> jax.Array:
    """y = A @ x for any device sparse format (jittable)."""
    from ..sparse.bdia import BdiaMatrix
    if isinstance(A, BdiaMatrix):
        return bdia_spmv(A, x)
    if isinstance(A, DiaMatrix):
        return dia_spmv_xla(A, x)
    if isinstance(A, EllMatrix):
        return ell_spmv_xla(A, x)
    if isinstance(A, (jax.Array, np.ndarray)):
        # dense operators here are AMG coarse levels / inverses — small,
        # and their products feed preconditioner consistency, so force
        # exact accumulation (a default-precision f32 matmul may round
        # its operands to TF32, ~1e-3 relative noise — enough to break
        # PCG)
        return jnp.matmul(A, x, precision=jax.lax.Precision.HIGHEST)
    if hasattr(A, "ndim") and A.ndim == 2:
        return A @ x         # duck-typed operator (linear/operator.py)
    raise TypeError(f"unknown matrix type {type(A)}")


# ---------------------------------------------------------------------------
# SpMM: sparse @ dense multi-vector (block Krylov / multiple RHS)
# ---------------------------------------------------------------------------

def ell_spmm_xla(A: EllMatrix, X: jax.Array) -> jax.Array:
    """Y = A @ X for dense X (n_cols, k_rhs); XLA gather over rows."""
    n = A.n_rows
    Xp = jnp.zeros((max(A.n_cols_pad, A.n_cols + 1), X.shape[1]),
                   dtype=X.dtype)
    Xp = Xp.at[: A.n_cols].set(X[: A.n_cols])
    g = jnp.take(Xp, A.cols, axis=0)             # (n_pad, k, k_rhs)
    # exact accumulation: SpMM feeds AMG construction products (Galerkin,
    # prolongator smoothing) where reduced-precision noise breaks PCG
    # consistency
    return jnp.einsum("nk,nkr->nr", A.data, g,
                      precision=jax.lax.Precision.HIGHEST)[:n]


def dia_spmm(A: DiaMatrix, X: jax.Array) -> jax.Array:
    """Y = A @ X for banded A: shift-and-fma over the whole (n, k) RHS
    block.  One pass streams the matrix ONCE for all k columns (a
    vmapped SpMV re-reads the diagonals per column).  XLA fuses the D
    shifted row-slices of X into one stencil loop."""
    n = A.n_rows
    n_cols = A.shape[1]
    n_pad = A.diags.shape[1]
    pad_lo = max(0, -min(A.offsets))
    # pad against X's row count (= n_cols), NOT n_rows — same rectangular
    # -operator clamping hazard as dia_spmv_xla
    pad_hi = max(0, max(0, max(A.offsets)) + n_pad - n_cols)
    k = X.shape[1]
    Xp = jnp.concatenate([
        jnp.zeros((pad_lo, k), X.dtype), X.astype(A.dtype),
        jnp.zeros((pad_hi, k), A.dtype)], axis=0)
    acc = jnp.zeros((n_pad, k), dtype=jnp.result_type(A.dtype, X.dtype))
    for d, off in enumerate(A.offsets):
        acc = acc + A.diags[d][:, None] * jax.lax.dynamic_slice(
            Xp, (off + pad_lo, 0), (n_pad, k))
    return acc[:n]


def matmat(A, X: jax.Array) -> jax.Array:
    """Y = A @ X (multi-vector SpMM dispatch, jittable)."""
    from ..sparse.bdia import BdiaMatrix
    if isinstance(A, BdiaMatrix):
        return bdia_spmm(A, X)
    if isinstance(A, DiaMatrix):
        return dia_spmm(A, X)
    if isinstance(A, EllMatrix):
        return ell_spmm_xla(A, X)
    if isinstance(A, (jax.Array, np.ndarray)):
        return jnp.matmul(A, X, precision=jax.lax.Precision.HIGHEST)
    return A @ X             # duck-typed operator
