"""Operator-algebra DSL: compose, add, scale, and invert linear operators.

The reference ships a broken/dead version of this (Linear/LinearOperator.py
— missing imports, undefined vars, not exported; SURVEY §7.3).  This is the
working equivalent: operators are closures over device state, so
any composition remains jittable; ``inverse`` defers to a solver factory at
apply time (the reference's InverseOp intent, LinearOperator.py:105-119).
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..ops import matvec as _matvec


class LinearOperator:
    """A shape-carrying matvec closure with operator algebra.

    Build from a matrix (`LinearOperator.from_matrix`) or a function.
    Supports ``A + B``, ``A - B``, ``c * A``, ``A @ B`` (composition),
    ``A.T`` (if a transpose closure is given), and ``A.inverse(solver_type)``.
    """

    def __init__(self, shape, apply_fn: Callable,
                 transpose_fn: Optional[Callable] = None):
        self.shape = tuple(shape)
        self._apply = apply_fn
        self._transpose = transpose_fn

    # ---- construction ----

    @staticmethod
    def from_matrix(A_dev, shape=None) -> "LinearOperator":
        shape = shape or A_dev.shape
        return LinearOperator(shape, lambda v: _matvec(A_dev, v))

    @staticmethod
    def identity(n: int) -> "LinearOperator":
        return LinearOperator((n, n), lambda v: v, lambda v: v)

    # ---- application ----

    def __call__(self, v):
        return self._apply(v)

    def matvec(self, v):
        return self._apply(v)

    # ---- algebra ----

    def __add__(self, other: "LinearOperator") -> "LinearOperator":
        if self.shape != other.shape:
            raise ValueError(f"shape mismatch {self.shape} vs {other.shape}")
        return LinearOperator(
            self.shape, lambda v: self._apply(v) + other._apply(v))

    def __sub__(self, other: "LinearOperator") -> "LinearOperator":
        if self.shape != other.shape:
            raise ValueError(f"shape mismatch {self.shape} vs {other.shape}")
        return LinearOperator(
            self.shape, lambda v: self._apply(v) - other._apply(v))

    def __mul__(self, c) -> "LinearOperator":
        if isinstance(c, LinearOperator):
            raise TypeError("use A @ B for operator composition; * is "
                            "scalar scaling only")
        return LinearOperator(self.shape, lambda v: c * self._apply(v))

    __rmul__ = __mul__

    def __neg__(self) -> "LinearOperator":
        return self * (-1.0)

    def __matmul__(self, other: "LinearOperator") -> "LinearOperator":
        if self.shape[1] != other.shape[0]:
            raise ValueError(f"compose mismatch {self.shape} @ {other.shape}")
        return LinearOperator(
            (self.shape[0], other.shape[1]),
            lambda v: self._apply(other._apply(v)))

    @property
    def T(self) -> "LinearOperator":
        if self._transpose is None:
            raise NotImplementedError("no transpose closure provided")
        return LinearOperator((self.shape[1], self.shape[0]),
                              self._transpose, self._apply)

    # ---- inversion ----

    def inverse(self, solver_type=None) -> "LinearOperator":
        """Operator that solves ``self @ x = v`` on application.

        Accepts a LinearSolverType factory (api.LinearSolverType); defaults
        to unpreconditioned GMRES.  Not jittable across the solve boundary
        (the solver returns a host SolveStatus), matching the deferred-
        solve semantics the reference intended (LinearOperator.py:105-119).
        """
        if self.shape[0] != self.shape[1]:
            raise ValueError("inverse of non-square operator")
        from .krylov import gmres_solve

        if solver_type is None:
            from ..core import StopReason

            def apply_inv(v):
                x, st, _ = gmres_solve(self._apply, v, maxiter=200,
                                       tau=1e-12)
                # match the solver_type branch: never hand back an
                # unconverged inverse-apply silently
                if int(st.reason) != StopReason.CONVERGED:
                    raise RuntimeError(
                        f"inverse apply failed: GMRES stopped with "
                        f"{StopReason(int(st.reason)).name} at residual "
                        f"{float(st.resid):.3e}")
                return x
            return LinearOperator(self.shape, apply_inv)

        def apply_inv(v):
            solver = solver_type.make_solver()
            st = solver.solve(_FnMatrix(self), v)
            if not st.success:
                raise RuntimeError(f"inverse apply failed: {st}")
            return st.soln

        return LinearOperator(self.shape, apply_inv)


class _FnMatrix:
    """Adapter so api solvers can treat a LinearOperator as a matrix."""

    def __init__(self, op: LinearOperator):
        self.op = op
        self.shape = op.shape
        self.ndim = 2

    def __matmul__(self, v):
        return self.op(v)
