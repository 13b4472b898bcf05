"""Device-mesh helpers for the 1-D row-partition layout.

The domain-appropriate parallelism for sparse solvers (SURVEY §2.3): rows
of the matrix and entries of every vector are sharded over a 1-D mesh; SpMV
needs halo exchange of the source vector; dot products and norms all-reduce.
The reference is single-process (no distribution anywhere); this module is
the scaling layer that replaces nothing and adds the multi-device story.
A flat 1-D mesh suits devices joined all to all (NVLink).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "rows"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    devs = np.array(devices if devices is not None
                    else jax.devices()[: (n_devices or len(jax.devices()))])
    return Mesh(devs, axis_names=(ROW_AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(ROW_AXIS))


def row2d_sharding(mesh: Mesh) -> NamedSharding:
    """Rows sharded, second dim replicated (ELL data/cols layout)."""
    return NamedSharding(mesh, P(ROW_AXIS, None))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_operator_rows(A_dev, mesh: Mesh):
    """Re-place an already-built device matrix with its rows sharded over
    the mesh (DIA stores rows in the diags' SECOND axis; ELL in the
    first).  Shared by linear/amg.py's mesh path and the distributed AMG
    setup so the two layouts can't drift."""
    from ..sparse.device import DiaMatrix, EllMatrix
    if isinstance(A_dev, DiaMatrix):
        return DiaMatrix(
            jax.device_put(A_dev.diags, NamedSharding(mesh, P(None, ROW_AXIS))),
            A_dev.offsets, A_dev.shape)
    if isinstance(A_dev, EllMatrix):
        sh2 = row2d_sharding(mesh)
        return EllMatrix(jax.device_put(A_dev.data, sh2),
                         jax.device_put(A_dev.cols, sh2),
                         A_dev.shape, A_dev.n_cols_pad)
    return jax.device_put(A_dev, row2d_sharding(mesh))
