"""Distributed AMG setup: hierarchy construction products built ON DEVICE.

The host-serial SA setup (linear/amg.py, mirroring reference
SmoothedAggregation.py) computes the smoothed prolongator and the Galerkin
triple product with host SpGEMM and replicates every level.  This module is
the device alternative: only the O(nnz)
aggregation runs on host; the construction PRODUCTS are device work over
the mesh:

* tentative prolongator → dense one-hot (n, nc), row-sharded over the mesh
  (SA gives one aggregate per row, so dense-tall is exact, not a cast);
* prolongator smoothing P = (I − ω D_f⁻¹ A_f) P̂ → sharded SpMM;
* Galerkin product A_c = R·A·P with R = Pᵀ →
  SpMM + one einsum contraction over the sharded row axis (GSPMD inserts
  the psum — this IS the on-device SpGEMM for the R·A·P of SURVEY §2.1,
  exact because SA coarse operators are small and dense-representable);
* coarse operator stays DENSE and is inverted on device
  (ops/dense_inverse.py) — coarse levels run as dense matmuls, the gather-coarse
  policy (coarse work is replicated, standard when it no longer fills the
  machine).

Memory gate: dense P is n×nc (nc ≈ n/9 for 2-D SA); the builder refuses
when it exceeds ``max_bytes`` — beyond that, use the host-SpGEMM path
(linear/amg.py), which scales in nnz.

Returns a ``DeviceHierarchy``, so ``v_cycle``/``amg_solve`` and the
AMGVCycle factory run it unchanged.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as PS

from ..linear.amg import (DeviceHierarchy, DeviceLevel, build_aggregates,
                          filtered_matrix)
from ..ops.dense_inverse import dense_inverse
from ..ops.spmv import matmat
from ..sparse.host import HostCSR
from .mesh import ROW_AXIS

_HI = jax.lax.Precision.HIGHEST


def pad_csr_identity(H: HostCSR, n_pad: int) -> HostCSR:
    """Extend a square CSR with unit-diagonal rows up to n_pad."""
    n = H.shape[0]
    if n_pad == n:
        return H
    rows, cols, vals = H.to_coo()
    extra = np.arange(n, n_pad)
    return HostCSR.from_coo(
        np.concatenate([rows, extra]), np.concatenate([cols, extra]),
        np.concatenate([vals, np.ones(n_pad - n, dtype=vals.dtype)]),
        (n_pad, n_pad), sum_duplicates=False)


def _device_op(A_host: HostCSR, dtype, mesh):
    """Row-sharded device matrix (DIA when banded, ELL otherwise)."""
    from ..api import as_device_matrix
    from .mesh import shard_operator_rows
    _, A_dev = as_device_matrix(A_host, dtype=dtype)
    if mesh is None:
        return A_dev
    return shard_operator_rows(A_dev, mesh)


import functools


@functools.partial(jax.jit, static_argnames=("nc", "omega", "dtype"))
def _setup_products(A_dev, Af_dev, dinv_f, agg_arr, *, nc, omega, dtype):
    """One jitted setup computation: smoothed P, R, dense A_c.

    Module-level jit (statics: nc/omega/dtype) so same-shaped hierarchy
    rebuilds — e.g. per Newton step — hit the compile cache instead of
    retracing (a per-call closure would retrace every build)."""
    P_hat = jax.nn.one_hot(agg_arr, nc, dtype=dtype)      # (n, nc)
    P = P_hat - omega * (dinv_f[:, None] * matmat(Af_dev, P_hat))
    AP = matmat(A_dev, P)                                  # (n, nc)
    # R = Pᵀ UNNORMALIZED, matching amg.sa_coarsen: the row-sum scaled
    # variant makes A_c non-symmetric on unstructured aggregates, which
    # breaks the V-cycle as an SPD PCG preconditioner (amg.sa_coarsen
    # docstring — PCG stalled at n=4.2M until this was removed)
    A_c = jnp.einsum("nc,nk->ck", P, AP, precision=_HI)    # Pᵀ A P
    R = P.T                                                # (nc, n)
    return P, R, A_c


def _coarsen_on_device(A_dev, Af_dev, dinv_f, agg, nc, omega, dtype):
    return _setup_products(A_dev, Af_dev, dinv_f, jnp.asarray(agg),
                           nc=nc, omega=float(omega), dtype=dtype)


_dense_inverse_jit = jax.jit(dense_inverse)


def build_distributed_hierarchy(A_host: HostCSR, mesh=None, *,
                                num_levels: int = 2, smoother: str = "jacobi",
                                nu_pre: int = 2, nu_post: int = 2,
                                base_tol: float = 0.08,
                                omega: float = 2.0 / 3.0,
                                dtype=np.float32,
                                max_bytes: int = 1 << 31,
                                coarse_inverse: str = "device"
                                ) -> DeviceHierarchy:
    """SA hierarchy with device-built construction products (see module
    docstring).  ``mesh`` row-shards the fine level and the transfer
    products; coarse levels are replicated (gathered) dense operators.
    """
    if smoother == "gs":
        raise ValueError("distributed setup provides jacobi/chebyshev "
                         "smoothing (GS needs triangular solves; use the "
                         "host path for GS parity)")
    if mesh is not None:
        # pad to lcm(8, n_dev) like linear/amg.py's mesh path: DiaMatrix
        # pads rows to a multiple of 8 internally, and the two paddings
        # must agree for the row sharding to divide evenly
        nd = int(mesh.devices.size)
        q = int(np.lcm(8, nd))
        n0 = A_host.shape[0]
        n_pad = ((n0 + q - 1) // q) * q
        if n_pad != n0:
            # identity padding rows: solves on the padded system restrict
            # exactly to the original coordinates for zero-padded b
            A_host = pad_csr_identity(A_host, n_pad)
    itemsize = np.dtype(dtype).itemsize

    levels = []          # built fine→coarse, reversed at the end
    A_cur_host: Optional[HostCSR] = A_host
    A_cur_dense: Optional[jax.Array] = None
    for lvl in range(num_levels - 1):
        tol = base_tol * (0.5 ** lvl)
        if A_cur_host is None:
            # coarser-than-second levels operate on the dense coarse
            # operator; aggregation needs sparsity info — re-sparsify on
            # host with a relative drop (the f32 device Galerkin product
            # leaves tiny nonzero noise everywhere; without the drop the
            # "sparse" coarse matrix is effectively dense)
            A_np = np.asarray(A_cur_dense, dtype=np.float64)
            A_cur_host = HostCSR.from_dense(
                A_np, tol=1e-10 * float(np.abs(A_np).max() or 1.0))
        n = A_cur_host.shape[0]
        agg = build_aggregates(A_cur_host, tol)
        nc = int(agg.max()) + 1 if n else 0
        if nc >= n or n <= 8:
            # coarsening stalled (every node its own aggregate) or the
            # level is already direct-solve-sized — stop here, like the
            # host path (build_sa_hierarchy); the current level becomes
            # the coarsest
            break
        if n * nc * itemsize > max_bytes:
            raise ValueError(
                f"dense prolongator {n}x{nc} exceeds max_bytes; use the "
                "host-SpGEMM hierarchy (linear/amg.py) at this scale")
        Af = filtered_matrix(A_cur_host, tol)
        d = Af.diagonal()
        d = np.where(d == 0, 1.0, d)
        dinv_f = jnp.asarray((1.0 / d).astype(dtype))
        A_dev = (_device_op(A_cur_host, dtype, mesh if lvl == 0 else None)
                 if A_cur_dense is None else A_cur_dense)
        Af_dev = _device_op(Af, dtype, mesh if lvl == 0 else None)
        if mesh is not None and lvl == 0:
            dinv_f = jax.device_put(dinv_f,
                                    NamedSharding(mesh, PS(ROW_AXIS)))
        P, R, A_c = _coarsen_on_device(A_dev, Af_dev, dinv_f, agg, nc,
                                       omega, dtype)

        d_op = A_cur_host.diagonal()
        d_op = np.where(d_op == 0, 1.0, d_op)
        dinv_op = jnp.asarray((1.0 / d_op).astype(dtype))
        if mesh is not None and lvl == 0:
            dinv_op = jax.device_put(dinv_op,
                                     NamedSharding(mesh, PS(ROW_AXIS)))
        cheb = None
        if smoother == "chebyshev":
            from ..linear.preconditioner import ChebyshevPreconditionerType
            lmax = ChebyshevPreconditionerType().estimate_lmax(A_cur_host)
            lmin = lmax / 30.0
            cheb = (0.5 * (lmax + lmin), 0.5 * (lmax - lmin))
        # P/R attach to the FINE side of each transfer (v_cycle convention:
        # lev.P_dev prolongates INTO this level, lev.R_dev restricts out)
        levels.append(DeviceLevel(A_dev, dinv_op, None, P, R, cheb))
        A_cur_host = None
        A_cur_dense = A_c

    # coarsest level — A_cur_dense is None when the loop never produced a
    # coarse operator (num_levels=1, or coarsening stalled at the finest
    # level): densify the current host matrix and direct-solve it, like
    # the host path
    A_c_np = (A_cur_dense if A_cur_dense is not None
              else jnp.asarray(A_cur_host.to_dense().astype(dtype)))
    if coarse_inverse == "device":
        A0_inv = _dense_inverse_jit(A_c_np.astype(dtype))
    else:
        A0_inv = jnp.asarray(
            np.linalg.inv(np.asarray(A_c_np, dtype=np.float64))
        ).astype(dtype)
    d0 = jnp.diagonal(A_c_np)
    d0 = jnp.where(d0 == 0, 1.0, d0).astype(dtype)
    levels.append(DeviceLevel(A_c_np.astype(dtype), 1.0 / d0, None, None,
                              None, None))

    # DeviceHierarchy stores levels coarsest-first with P/R on the FINE
    # level entry (v_cycle: lev.P_dev prolongates INTO this level)
    levels.reverse()
    return DeviceHierarchy(levels, A0_inv, smoother, nu_pre, nu_post)
