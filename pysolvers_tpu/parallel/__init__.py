from .mesh import make_mesh, row_sharding, replicated, ROW_AXIS
from .spmv import (ShardedDia, ShardedEll, ShardedEllHalo, shard_dia,
                   shard_ell, shard_ell_halo, dist_dia_spmv, dist_ell_spmv,
                   dist_ell_halo_spmv, pad_vector_dia, pad_vector_ell,
                   pad_vector_ell_halo)
from .precond import (BlockJacobiILU, build_block_jacobi_ilu,
                      block_jacobi_apply,
                      BlockJacobiILUPreconditionerType)

__all__ = [
    "make_mesh", "row_sharding", "replicated", "ROW_AXIS",
    "ShardedDia", "ShardedEll", "ShardedEllHalo", "shard_dia",
    "shard_ell", "shard_ell_halo", "dist_dia_spmv", "dist_ell_spmv",
    "dist_ell_halo_spmv", "pad_vector_dia", "pad_vector_ell",
    "pad_vector_ell_halo",
    "BlockJacobiILU", "build_block_jacobi_ilu", "block_jacobi_apply",
    "BlockJacobiILUPreconditionerType",
]
