from .spmv import matvec, matmat, ell_spmv_xla, dia_spmv_xla

__all__ = ["matvec", "matmat", "ell_spmv_xla", "dia_spmv_xla"]
