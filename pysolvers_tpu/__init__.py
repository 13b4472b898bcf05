"""pysolvers_tpu — a sparse linear-algebra and iterative-solver framework
on JAX / XLA, with the capability surface of PySolvers (reference:
krlong014/PySolvers) redesigned for an accelerator.

Layers (bottom-up):
  sparse/    host + device sparse containers, MatrixMarket I/O
  ops/       XLA kernels: SpMV, triangular solves, fused setup
  linear/    Krylov solvers, preconditioners, AMG, direct solver
  nonlinear/ inexact Newton, line searches
  parallel/  device-mesh partitioning, halo exchange, distributed solvers
  problems/  FD Laplacians, Bratu, Debye-Hückel matrix suite
  api        thin OO shell: factory types, config, SolveStatus (reference
             API-surface parity)
"""

__version__ = "0.1.0"

from . import ops, problems, sparse, linear
from .core import SolverConfig, SolveStatus, StopReason
from .sparse import (HostCSR, EllMatrix, DiaMatrix, BdiaMatrix,
                     read_mtx, write_mtx)
from .ops import matvec
from .linear import (cg_solve, cg_solve_multi, gmres_solve,
                     gmres_solve_multi)
from . import api
from .api import (CommonSolverArgs, PCG, GMRES, DefaultDirect,
                  LinearSolverType, IterativeLinearSolverType)
from .linear.ilu import ILUTPreconditionerType, ICPreconditionerType
from .linear.preconditioner import (IdentityPreconditionerType,
                                    JacobiPreconditionerType,
                                    ChebyshevPreconditionerType)
from .linear import amg as _amg
from .linear.amg import AMG, AMGPreconditionerType, AMGVCycle
from .linear.gmg import GMGVCycle, GMGPreconditionerType
from .linear.gmg_grid import (GridHierarchy, build_grid_hierarchy,
                              build_grid_hierarchy_device, v_cycle_grid)
from . import nonlinear
from .nonlinear import (NewtonSolver, FuncAdapter1D, SimpleBacktrack,
                        TrivialLinesearch)
from .solve import solve
from .prime import prime_cache

# reference-style aliases (ILUTPreconditioner.py:10-31, ICPreconditioner.py:20-29)
RightILUT = ILUTPreconditionerType
LeftILUT = lambda *a, **k: ILUTPreconditionerType(*a, side="left", **k)
RightIC = ICPreconditionerType

__all__ = [
    "SolverConfig", "SolveStatus", "StopReason", "CommonSolverArgs",
    "HostCSR", "EllMatrix", "DiaMatrix", "BdiaMatrix", "read_mtx",
    "write_mtx",
    "matvec", "cg_solve", "cg_solve_multi", "gmres_solve",
    "gmres_solve_multi",
    "PCG", "GMRES", "DefaultDirect", "LinearSolverType",
    "IterativeLinearSolverType",
    "ILUTPreconditionerType", "ICPreconditionerType", "RightILUT",
    "LeftILUT", "RightIC",
    "IdentityPreconditionerType", "JacobiPreconditionerType",
    "ChebyshevPreconditionerType",
    "AMG", "AMGPreconditionerType", "AMGVCycle", "GMGVCycle",
    "GMGPreconditionerType",
    "GridHierarchy", "build_grid_hierarchy", "build_grid_hierarchy_device",
    "v_cycle_grid",
    "NewtonSolver", "FuncAdapter1D", "SimpleBacktrack", "TrivialLinesearch",
    "solve", "prime_cache",
]
