"""Distributed block-DIA SpMV: block-row slabs with ppermute halos.

The BSR-class analog of ``dist_dia_spmv`` (parallel/spmv.py): planes are
sharded along the block-row axis, the halo is the block-band overlap
(max |block offset| block-columns per dof), fetched from the two mesh
neighbors with ``ppermute`` — rides ICI neighbor links, no all-gather.

Vectors are PLANAR and 2-D here: shape (b, nb_pad) sharded
``P(None, ROW_AXIS)`` — each device holds a (b, slab) slab of every dof
plane, so the halo exchange is one contiguous (b, h) slice per direction
and the local compute is the same shift-and-FMA as the single-chip
kernel (ops/spmv.py::_bdia_xla).  Krylov solvers run unchanged on 2-D
vectors (their dots/norms reduce over all axes; GSPMD inserts the psum).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from ..sparse.bdia import BdiaMatrix
from .mesh import ROW_AXIS


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedBdia:
    """Planes (D·b, b, nb_pad) sharded on the block-row axis."""

    planes: jax.Array
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    b: int = dataclasses.field(metadata=dict(static=True))
    mesh: Mesh = dataclasses.field(metadata=dict(static=True))

    @property
    def nb(self) -> int:
        return self.shape[0] // self.b

    @property
    def nb_pad(self) -> int:
        return self.planes.shape[-1]

    @property
    def dtype(self):
        return self.planes.dtype

    # planar-order boundary helpers (2-D variant of BdiaMatrix's)
    def to_planar(self, x):
        """Node-major (n,) host/device vector -> (b, nb_pad) sharded."""
        nb, b = self.nb, self.b
        xb = jnp.asarray(x).reshape(nb, b).T                  # (b, nb)
        xb = jnp.pad(xb, ((0, 0), (0, self.nb_pad - nb)))
        return jax.device_put(xb, NamedSharding(self.mesh,
                                                P(None, ROW_AXIS)))

    def from_planar(self, xb):
        nb, b = self.nb, self.b
        return xb[:, :nb].T.reshape(nb * b)


def shard_bdia(A: BdiaMatrix, mesh: Mesh) -> ShardedBdia:
    """Shard a BdiaMatrix over a 1-D mesh.  The block-row axis is padded
    so each shard's slab is a multiple of 8 and >= the block halo."""
    n_dev = int(mesh.devices.size)
    h_lo = max(0, -min(A.offsets))
    h_hi = max(0, max(A.offsets))
    nb = A.nb
    slab = _ceil_to(max((nb + n_dev - 1) // n_dev, h_lo, h_hi, 8), 8)
    nb_pad = slab * n_dev
    planes = A.planes
    if planes.shape[-1] < nb_pad:
        planes = jnp.pad(planes, ((0, 0), (0, 0),
                                  (0, nb_pad - planes.shape[-1])))
    elif planes.shape[-1] > nb_pad:
        planes = planes[:, :, :nb_pad]
    planes = jax.device_put(planes,
                            NamedSharding(mesh, P(None, None, ROW_AXIS)))
    return ShardedBdia(planes, A.offsets, A.shape, A.b, mesh)


def dist_bdia_spmv(A: ShardedBdia, xb: jax.Array) -> jax.Array:
    """y = A @ x for (b, nb_pad) planar x sharded on the block-row axis.
    One ppermute per direction; local compute is gather-free
    shift-and-FMA.  Jittable."""
    offsets = A.offsets
    b = A.b
    h_lo = max(0, -min(offsets))
    h_hi = max(0, max(offsets))
    mesh = A.mesh
    n_dev = int(mesh.devices.size)
    slab = A.nb_pad // n_dev

    def local(planes_s, x_s):
        x_s = x_s.reshape(b, slab)
        if h_lo > 0 and n_dev > 1:
            lo = jax.lax.ppermute(
                x_s[:, slab - h_lo:], ROW_AXIS,
                [(i, (i + 1) % n_dev) for i in range(n_dev)])
        else:
            lo = jnp.zeros((b, h_lo), x_s.dtype)
        if h_hi > 0 and n_dev > 1:
            hi = jax.lax.ppermute(
                x_s[:, :h_hi], ROW_AXIS,
                [(i, (i - 1) % n_dev) for i in range(n_dev)])
        else:
            hi = jnp.zeros((b, h_hi), x_s.dtype)
        if n_dev > 1:
            idx = jax.lax.axis_index(ROW_AXIS)
            lo = jnp.where(idx == 0, jnp.zeros_like(lo), lo)
            hi = jnp.where(idx == n_dev - 1, jnp.zeros_like(hi), hi)
        xw = jnp.concatenate([lo, x_s, hi], axis=1)
        acc = jnp.zeros((b, slab),
                        dtype=jnp.result_type(planes_s.dtype, x_s.dtype))
        for d, off in enumerate(offsets):
            xs = jax.lax.dynamic_slice(xw, (0, off + h_lo), (b, slab))
            for q in range(b):
                acc = acc + planes_s[d * b + q] * xs[q:q + 1, :]
        return acc

    f = shard_map(local, mesh=mesh,
                  in_specs=(P(None, None, ROW_AXIS), P(None, ROW_AXIS)),
                  out_specs=P(None, ROW_AXIS))
    return f(A.planes, xb)


def block_jacobi_sharded(A: ShardedBdia):
    """(apply, state): block-Jacobi for a sharded BDIA operator — the
    diagonal blocks are inverted on device (batched Gauss-Jordan) with
    the inverse planes sharded like the operator; apply is one einsum,
    no collectives (block-diagonal => shard-local)."""
    from ..linear.block_precond import batched_inverse
    if 0 not in A.offsets:
        raise ValueError("sharded BDIA block-Jacobi needs the offset-0 "
                         "block diagonal")
    d0 = A.offsets.index(0)
    b = A.b
    D = A.planes[d0 * b:(d0 + 1) * b].transpose(2, 1, 0)   # (nb_pad, p, q)
    # pad rows (zero blocks) invert to garbage harmlessly: their x rows
    # are zero and their y rows are ignored; guard singularity with I
    eye = jnp.eye(b, dtype=D.dtype)
    is_zero = jnp.all(D == 0, axis=(1, 2))[:, None, None]
    D = jnp.where(is_zero, eye, D)
    Binv_pl = batched_inverse(D).transpose(1, 2, 0)        # (b, b, nb_pad)
    Binv_pl = jax.device_put(
        Binv_pl, NamedSharding(A.mesh, P(None, None, ROW_AXIS)))

    def apply(state, v):
        return jnp.einsum("pqi,qi->pi", state.astype(v.dtype), v,
                          precision=jax.lax.Precision.HIGHEST)

    return apply, Binv_pl
