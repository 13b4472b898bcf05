"""Block-DIA: the BSR-class container for block-banded operators.

The reference (scipy CSR everywhere, e.g. ``mvmult``
IterativeLinearSolver.py:94-106) treats multi-dof-per-node FEM matrices
as scalar sparse; scipy's own BSR answers that on CPU with small dense
blocks.  The device equivalent here is NOT a block-CSR (block gathers)
but the DIA idea lifted to blocks: an
RCM-ordered multi-dof discretization is **block-banded**, so store the
dense b×b blocks along block-diagonals and run SpMV as gather-free
shift-and-FMA — zero gathers, exactly like the scalar DIA SpMV with
the block mixing fused in.

Layout — PLANAR (dof-major) vector ordering: the solve-side vectors hold
all dof-0 values first, then dof-1, ... (x_planar[p·nb + i] =
x[i·b + p]).  In planar order each (p, q) plane of a block-diagonal is a
contiguous nb-length stream FMA'd against a SHIFTED nb-segment of x —
contiguous and transpose-free (node-major vectors would pay two
full-vector transposes per matvec for identical arithmetic).  Blocks are stored kernel-ready as
``planes[d·b + q, p, i] = A_block[boffs[d]][p, q] at block-row i`` so the
SpMV reads contiguous (b, nb) slabs.

Conversion helpers ``to_planar``/``from_planar`` reorder once per solve,
not per matvec.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .device import _round_up
from .host import HostCSR


# structure-keyed layout plans (see device._DIA_PLAN_CACHE)
_BDIA_PLAN_CACHE: dict = {}


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BdiaMatrix:
    """Block-banded matrix as dense blocks on block-diagonals.

    planes:  (n_boffs·b, b, nb_pad) — planes[d·b+q, p, i] =
             A[i·b+p, (i+offsets[d])·b+q]  (kernel-ready planar layout)
    offsets: static tuple of BLOCK offsets.
    b:       static block size; shape is the SCALAR shape (n, n).

    ``matvec``/``matmat`` operate on PLANAR-ordered vectors (see module
    docstring); reorder once per solve with to_planar/from_planar.
    """

    planes: jax.Array
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    b: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def nb(self) -> int:
        return self.shape[0] // self.b

    @property
    def nb_pad(self) -> int:
        return self.planes.shape[-1]

    @property
    def dtype(self):
        return self.planes.dtype

    @property
    def nnz_stored(self) -> int:
        return int(np.prod(self.planes.shape))

    @staticmethod
    def from_host_csr(A: HostCSR, b: int, dtype=None,
                      row_tile: int = 8) -> "BdiaMatrix":
        """Pack a host CSR (node-major, n divisible by ``b``) into
        planar block-DIA.  Blocks are dense in storage (absent entries
        are zeros).  The layout plan (block offsets + per-nnz scatter
        target) is cached on the sparsity structure, like
        DiaMatrix.from_host_csr."""
        n, m = A.shape
        if n != m:
            raise ValueError("BdiaMatrix is square-only")
        if n % b != 0:
            raise ValueError(f"n={n} not divisible by block size b={b}")
        nb = n // b
        dtype = dtype or A.data.dtype
        nb_pad = _round_up(max(nb, 1), row_tile)

        # nb_pad is baked into the cached flat scatter targets — it must
        # key the plan or a different row_tile would scatter values to
        # wrong plane positions
        key = (hash(A.indptr.tobytes()), hash(A.indices.tobytes()),
               A.nnz, A.shape, b, nb_pad)
        ent = _BDIA_PLAN_CACHE.get(key)
        if ent is None:
            rows, cols, _ = A.to_coo()
            br, p = rows // b, rows % b
            bc, q = cols // b, cols % b
            boffs = np.unique(bc - br)
            d_idx = np.searchsorted(boffs, bc - br)
            # flat scatter target into (n_boffs·b [d,q], b [p], nb_pad)
            flat = ((d_idx * b + q) * b + p) * nb_pad + br
            ent = (tuple(int(o) for o in boffs), flat.astype(np.int64))
            if len(_BDIA_PLAN_CACHE) > 16:
                _BDIA_PLAN_CACHE.pop(next(iter(_BDIA_PLAN_CACHE)))
            _BDIA_PLAN_CACHE[key] = ent
        boffs, flat = ent
        planes = np.zeros(len(boffs) * b * b * nb_pad, dtype=dtype)
        planes[flat] = A.data
        planes = planes.reshape(len(boffs) * b, b, nb_pad)
        return BdiaMatrix(jnp.asarray(planes), boffs, (n, n), b)

    # ---------------- planar-order boundary helpers ----------------

    def to_planar(self, x):
        """Node-major (n,) or (n, k) -> planar ordering (one transpose,
        paid at solve entry, not per matvec)."""
        nb, b = self.nb, self.b
        if x.ndim == 1:
            return x.reshape(nb, b).T.reshape(nb * b)
        k = x.shape[1]
        return x.reshape(nb, b, k).transpose(1, 0, 2).reshape(nb * b, k)

    def from_planar(self, x):
        nb, b = self.nb, self.b
        if x.ndim == 1:
            return x.reshape(b, nb).T.reshape(nb * b)
        k = x.shape[1]
        return x.reshape(b, nb, k).transpose(1, 0, 2).reshape(nb * b, k)

    @staticmethod
    def is_profitable(A: HostCSR, b: int, max_boffs: int = 32) -> bool:
        """Block-banded enough: few distinct block offsets AND the dense
        block storage doesn't balloon past ~2.5× the scalar nnz."""
        n = A.shape[0]
        if n % b != 0 or A.shape[0] != A.shape[1]:
            return False
        rows, cols, _ = A.to_coo()
        boffs = np.unique(cols // b - rows // b)
        if len(boffs) > max_boffs:
            return False
        stored = len(boffs) * b * b * (n // b)
        return stored <= 2.5 * A.nnz

    def diag_blocks(self) -> jax.Array:
        """(nb, b, b) dense diagonal blocks D_i (device array) — the
        block-Jacobi setup input (linear/block_precond.py).  Requires a
        stored offset-0 block diagonal."""
        if 0 not in self.offsets:
            raise ValueError("BdiaMatrix has no offset-0 block diagonal")
        d0 = self.offsets.index(0)
        # planes[d0·b+q, p, i] = D_i[p, q] -> (nb, b, b) as [i, p, q]
        return self.planes[d0 * self.b:(d0 + 1) * self.b,
                           :, :self.nb].transpose(2, 1, 0)

    def diagonal_planar(self) -> jax.Array:
        """Scalar diagonal in PLANAR ordering, shape (b·nb,) — feeds
        point-Jacobi/Chebyshev scaling without leaving planar layout."""
        if 0 not in self.offsets:
            raise ValueError("BdiaMatrix has no offset-0 block diagonal")
        d0 = self.offsets.index(0)
        idx = jnp.arange(self.b)
        d = self.planes[d0 * self.b + idx, idx, :self.nb]    # (b, nb)
        return d.reshape(self.b * self.nb)

    def host_matvec_planar(self, x: np.ndarray) -> np.ndarray:
        """f64 numpy matvec on PLANAR-ordered x — the high-precision
        residual oracle for mixed-precision BDIA solves (refine/rr
        machinery) without densifying to CSR."""
        pl_ = np.asarray(self.planes, dtype=np.float64)
        b, nb = self.b, self.nb
        xb = np.asarray(x, dtype=np.float64).reshape(b, nb)
        acc = np.zeros((b, nb))
        for d, off in enumerate(self.offsets):
            lo = max(0, -off)
            hi = min(nb, nb - off)
            if hi <= lo:
                continue
            for q in range(b):
                acc[:, lo:hi] += (pl_[d * b + q][:, lo:hi]
                                  * xb[q, lo + off:hi + off])
        return acc.reshape(b * nb)

    def to_host_csr(self) -> HostCSR:
        pl_ = np.asarray(self.planes)
        nb, b = self.nb, self.b
        rows_l, cols_l, vals_l = [], [], []
        for d, off in enumerate(self.offsets):
            for q in range(b):
                for p in range(b):
                    i = np.arange(nb)
                    j = i + off
                    ok = (j >= 0) & (j < nb)
                    rows_l.append(i[ok] * b + p)
                    cols_l.append(j[ok] * b + q)
                    vals_l.append(pl_[d * b + q, p, i[ok]])
        return HostCSR.from_coo(np.concatenate(rows_l),
                                np.concatenate(cols_l),
                                np.concatenate(vals_l), self.shape)

    def astype(self, dtype) -> "BdiaMatrix":
        return BdiaMatrix(self.planes.astype(dtype), self.offsets,
                          self.shape, self.b)


def detect_block_size(A: HostCSR, candidates=(8, 7, 6, 5, 4, 3, 2),
                      max_boffs: int = 32, min_density: float = 0.7):
    """Largest candidate b for which ``A`` has genuine b×b block-DIA
    structure, or None.

    Two tests per candidate: few distinct BLOCK offsets (block-banded),
    and block DENSITY ≥ ``min_density`` — the fraction of dense-block
    storage positions that hold a structural nonzero.  Density is the
    discriminator that storage-ratio alone is not: a scalar 5-point
    stencil at b=2 stores 10n positions for ~5n nonzeros (density 0.5,
    rejected — and its ``solve()`` auto path keeps the scalar AMG route,
    which a silent b=2 conversion would have swapped for weak
    block-Jacobi), while a multi-dof discretization with dense blocks
    sits near 1.0.  Cost is one COO view + one unique per candidate,
    O(nnz·|candidates|) on host — negligible against the conversion it
    gates.

    Feeds ``solve()``'s auto-conversion (solve.py): CSR holders reach
    the BDIA lockstep route without hand-building a
    BdiaMatrix (reference analog: ``mvmult``'s dispatch-on-type idea,
    IterativeLinearSolver.py:94-106).
    """
    n, m = A.shape
    if n != m or A.nnz == 0:
        return None
    rows, cols, _ = A.to_coo()
    for b in candidates:
        if n % b:
            continue
        boffs = np.unique(cols // b - rows // b)
        if len(boffs) > max_boffs:
            continue
        if A.nnz >= min_density * len(boffs) * b * b * (n // b):
            return b
    return None
