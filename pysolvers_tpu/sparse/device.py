"""Device-resident sparse matrix formats (JAX pytrees, static shapes).

XLA requires static shapes, so the device formats are padded:

* ``EllMatrix`` — padded ELLPACK: ``data``/``cols`` of shape (n_rows_pad, k).
  General-purpose; SpMV is an XLA gather.  Padding entries have
  ``col = n_cols`` (sentinel, reads a zero pad slot) and ``data = 0``.

* ``EllTMatrix`` — the same table slot-major, (k, n_rows_pad).

* ``DiaMatrix`` — diagonal storage for banded matrices (FD stencils): dense
  diagonals + static integer offsets.  SpMV is shift-and-fma — gather-free,
  the fastest path for structured problems.

Capability parity: these replace the reference's use of scipy CSR + C SpMV
(reference: PySolvers/Linear/IterativeLinearSolver.py:94-106 `mvmult`).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .host import HostCSR

# structure-keyed DIA layout plans (DiaMatrix.from_host_csr)
_DIA_PLAN_CACHE: dict = {}
# device-resident ELL column tables (EllMatrix.from_host_csr)
_ELL_COLS_CACHE: dict = {}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Padded ELLPACK sparse matrix on device.

    data: (n_rows_pad, k) values, zero-padded
    cols: (n_rows_pad, k) int32 column indices (padding slots = n_cols)
    shape / n_rows_pad / k are static (aux) fields.
    """

    data: jax.Array
    cols: jax.Array
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    n_cols_pad: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def n_rows_pad(self) -> int:
        return self.data.shape[0]

    @property
    def k(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        """Upper bound (padded) — true nnz is tracked host-side."""
        return self.data.shape[0] * self.data.shape[1]

    @staticmethod
    def from_host_csr(A: HostCSR, dtype=None, row_tile: int = 8,
                      k_align: int = 1) -> "EllMatrix":
        """Pack a host CSR into padded ELL (setup phase, host).

        The column-index table is STRUCTURE: it is kept device-resident
        in a content-keyed cache, so a same-structure re-pack (Newton
        steps, the f32/f64 pair of one operator) uploads only the value
        table."""
        n, m = A.shape
        counts = A.row_nnz()
        k = max(int(counts.max()) if len(counts) else 1, 1)
        k = _round_up(k, k_align)
        n_pad = _round_up(max(n, 1), row_tile)
        dtype = dtype or A.data.dtype
        data = np.zeros((n_pad, k), dtype=dtype)
        rows, cs, vs = A.to_coo()
        skey = (hash(A.indptr.tobytes()), hash(A.indices.tobytes()),
                A.nnz, A.shape, k, n_pad)
        ent = _ELL_COLS_CACHE.get(skey)
        if ent is None:
            # padding slots point one past the real columns (data is 0 so
            # any gathered value is harmless) — keeps explicitly stored
            # zeros distinguishable from padding for exact round-trips
            cols = np.full((n_pad, k), m, dtype=np.int32)
            slot = (np.arange(len(rows)) - A.indptr[rows]
                    if len(rows) else np.zeros(0, np.int64))
            if len(rows):
                cols[rows, slot] = cs
            ent = (jnp.asarray(cols), slot)
            if len(_ELL_COLS_CACHE) > 16:
                _ELL_COLS_CACHE.pop(next(iter(_ELL_COLS_CACHE)))
            _ELL_COLS_CACHE[skey] = ent
        cols_dev, slot = ent
        if len(rows):
            data[rows, slot] = vs
        return EllMatrix(jnp.asarray(data), cols_dev, (n, m),
                         _round_up(max(m, 1), row_tile))

    def to_host_csr(self) -> HostCSR:
        data = np.asarray(self.data)[: self.n_rows]
        cols = np.asarray(self.cols)[: self.n_rows]
        mask = cols < self.n_cols        # padding sentinel = n_cols
        rows = np.broadcast_to(
            np.arange(self.n_rows)[:, None], data.shape)[mask]
        return HostCSR.from_coo(rows, cols[mask], data[mask], self.shape)

    def astype(self, dtype) -> "EllMatrix":
        return EllMatrix(self.data.astype(dtype), self.cols, self.shape,
                         self.n_cols_pad)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EllTMatrix:
    """SLOT-MAJOR padded ELL: data_t/cols_t are (k, n_rows_pad).

    Each of the k slot streams is a flat (n,) vector, so its gathers are
    1-D.  Used for the dd-chain's f64 residual oracle
    (ops.spmv.ellt_spmv_f64); `EllMatrix` remains the
    general-purpose container.
    """

    data_t: jax.Array
    cols_t: jax.Array
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    n_cols_pad: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def n_rows_pad(self) -> int:
        return self.data_t.shape[1]

    @property
    def k(self) -> int:
        return self.data_t.shape[0]

    @property
    def dtype(self):
        return self.data_t.dtype

    @staticmethod
    def from_host_csr(A: HostCSR, dtype=None, row_tile: int = 8,
                      k_align: int = 1) -> "EllTMatrix":
        n, m = A.shape
        counts = A.row_nnz()
        k = max(int(counts.max()) if len(counts) else 1, 1)
        k = _round_up(k, k_align)
        n_pad = _round_up(max(n, 1), row_tile)
        dtype = dtype or A.data.dtype
        rows, cs, vs = A.to_coo()
        slot = (np.arange(len(rows)) - A.indptr[rows]
                if len(rows) else np.zeros(0, np.int64))
        cols_t = np.full((k, n_pad), m, dtype=np.int32)
        data_t = np.zeros((k, n_pad), dtype=dtype)
        if len(rows):
            cols_t[slot, rows] = cs
            data_t[slot, rows] = vs
        return EllTMatrix(jnp.asarray(data_t), jnp.asarray(cols_t),
                          (n, m), _round_up(max(m, 1), row_tile))

    def astype(self, dtype) -> "EllTMatrix":
        return EllTMatrix(self.data_t.astype(dtype), self.cols_t,
                          self.shape, self.n_cols_pad)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Banded matrix as dense diagonals (gather-free SpMV).

    diags:   (n_diags, n_rows_pad) — diags[d, i] = A[i, i + offsets[d]]
    offsets: static tuple of ints.
    """

    diags: jax.Array
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def dtype(self):
        return self.diags.dtype

    @staticmethod
    def from_host_csr(A: HostCSR, dtype=None,
                      row_tile: int = 8) -> "DiaMatrix":
        n, m = A.shape
        n_pad = _round_up(max(n, 1), row_tile)
        dtype = dtype or A.data.dtype
        # structure-keyed layout plan (offsets + per-nnz scatter target):
        # depends only on the sparsity pattern, so same-structure rebuilds
        # (the f32/f64 pair of one operator, Newton re-assemblies) skip
        # the to_coo/unique/searchsorted passes — measured 0.3-0.9 s of
        # noisy host work per build at n=10^6 (the symbolic/numeric split,
        # like HostCSR.permute_symmetric)
        key = (hash(A.indptr.tobytes()), hash(A.indices.tobytes()),
               A.nnz, A.shape)
        ent = _DIA_PLAN_CACHE.get(key)
        if ent is None:
            rows, cols, _ = A.to_coo()
            offs = np.unique(cols - rows)
            off_idx = np.searchsorted(offs, cols - rows)
            ent = (tuple(int(o) for o in offs),
                   off_idx.astype(np.int32), rows.astype(np.int64))
            if len(_DIA_PLAN_CACHE) > 16:
                _DIA_PLAN_CACHE.pop(next(iter(_DIA_PLAN_CACHE)))
            _DIA_PLAN_CACHE[key] = ent
        offs, off_idx, rows = ent
        diags = np.zeros((len(offs), n_pad), dtype=dtype)
        diags[off_idx, rows] = A.data
        return DiaMatrix(jnp.asarray(diags), offs, (n, m))

    @staticmethod
    def is_profitable(A: HostCSR, max_diags: int = 32) -> bool:
        rows, cols, _ = A.to_coo()
        return len(np.unique(cols - rows)) <= max_diags
