"""2D Bratu nonlinear test problem.

Capability parity with the reference's examples/FDBratu2D.py:10-29:
F(u) = A·u − alpha·exp(−u) with A the (negative) 2D FD Laplacian;
J(u) = A + diag(alpha·exp(−u)).  Note the reference uses exp(−u) (its
FDBratu2D.py:21 `np.exp(-u)`), giving Jacobian A + alpha·diag(exp(−u))
(FDBratu2D.py:27-29 adds to the diagonal).  evalF/evalJ run on device
(SpMV + elementwise); the Jacobian reuses the Laplacian's sparsity so the
device matrix is rebuilt with a diagonal bump only — no host round-trip.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..sparse.host import HostCSR
from ..sparse.device import DiaMatrix, EllMatrix
from .laplacian import fd_laplacian_2d


class Bratu2D:
    """F(u) = A u − alpha e^{−u}, J(u) = A + alpha diag(e^{−u}).

    The device Jacobian is produced by updating the diagonal entries of the
    stored device matrix in place (both DIA and ELL keep the diagonal at a
    statically known position), so Newton steps never rebuild from host.
    """

    def __init__(self, m: int = 100, alpha: float = 0.5, fmt: str = "dia",
                 dtype=np.float64):
        self.m = m
        self.n = m * m
        self.alpha = alpha
        self.A_host = fd_laplacian_2d(m, dtype=dtype)
        # position of each diagonal entry in the host CSR data array, so the
        # host Jacobian is a vectorized diagonal bump (no reassembly)
        rows_h, cols_h, _ = self.A_host.to_coo()
        self._host_diag_pos = np.flatnonzero(rows_h == cols_h)
        if fmt == "dia":
            self.A = DiaMatrix.from_host_csr(self.A_host)
            self._diag_idx = self.A.offsets.index(0)
        elif fmt == "ell":
            self.A = EllMatrix.from_host_csr(self.A_host)
            # slot of the diagonal entry within each ELL row
            cols = np.asarray(self.A.cols)[: self.n]
            slots = np.argmax(
                cols == np.arange(self.n)[:, None], axis=1).astype(np.int32)
            self._diag_slots = jnp.asarray(slots)
        else:
            raise ValueError(fmt)
        self.fmt = fmt

    def eval_f(self, u: jax.Array) -> jax.Array:
        from ..ops import matvec
        return matvec(self.A, u) - self.alpha * jnp.exp(-u)

    def eval_j(self, u: jax.Array):
        """Return the Jacobian at u as a (host, device) pair.

        The device matrix is the stored Laplacian with a diagonal bump (no
        host round-trip for the SpMV path); the host CSR twin feeds
        preconditioner setup (formed once per solve under freeze_prec).
        """
        bump = self.alpha * jnp.exp(-u)
        if self.fmt == "dia":
            d = self.A.diags.at[self._diag_idx, : self.n].add(
                bump.astype(self.A.dtype))
            J_dev = DiaMatrix(d, self.A.offsets, self.A.shape)
        else:
            rows = jnp.arange(self.n)
            data = self.A.data.at[rows, self._diag_slots].add(
                bump.astype(self.A.dtype))
            J_dev = EllMatrix(data, self.A.cols, self.A.shape,
                              self.A.n_cols_pad)
        J_host = self.A_host.copy()
        J_host.data[self._host_diag_pos] += np.asarray(
            bump, dtype=J_host.data.dtype)
        return J_host, J_dev

    def eval_j_dev(self, u: jax.Array):
        """Device-only Jacobian (jittable, no host twin) — feeds the
        fully-jitted explicit-J Newton path (newton_krylov_solve eval_j)."""
        bump = self.alpha * jnp.exp(-u)
        if self.fmt == "dia":
            d = self.A.diags.at[self._diag_idx, : self.n].add(
                bump.astype(self.A.dtype))
            return DiaMatrix(d, self.A.offsets, self.A.shape)
        rows = jnp.arange(self.n)
        data = self.A.data.at[rows, self._diag_slots].add(
            bump.astype(self.A.dtype))
        return EllMatrix(data, self.A.cols, self.A.shape, self.A.n_cols_pad)

    def jacobi_precond(self, J, v: jax.Array) -> jax.Array:
        """Setup-free Jacobi preconditioner from the CURRENT Jacobian
        (newton_krylov_solve precond_from_j)."""
        if self.fmt == "dia":
            d = J.diags[self._diag_idx, : self.n]
        else:
            d = J.data[jnp.arange(self.n), self._diag_slots]
        return v / d

    # protocol used by the Newton driver (reference Newton.py:35,59)
    evalF = eval_f
    evalJ = eval_j


class Bratu2DHostOuter:
    """Newton-outer-on-host adapter around :class:`Bratu2D`.

    F and the host Jacobian run on the host — no device dispatch per
    line-search step, and extended-precision F; the device Jacobian twin is
    still produced so the inner (mixed-precision) solver keeps its fast
    DIA kernel path.  This is the recommended ``func`` for host-driven
    Newton; the fully-jitted paths (newton_krylov_solve) use
    :class:`Bratu2D` directly.
    """

    def __init__(self, prob: Bratu2D):
        self.prob = prob
        self.n = prob.n
        # extended-precision CSR data for the outer residual: F(u) has
        # catastrophic cancellation ((1/h^2)·(4u - sum of neighbors) vs
        # alpha·e^{-u}); its f64 evaluation floor is ~|A|·eps64 ≈ 1e-11
        # for m=100, right AT the tau=1e-12 target (reference
        # FDBratu2D.py:36-48) — longdouble accumulation drops the floor
        # ~1000x so the final Newton steps see true decrease
        self._data_l = prob.A_host.data.astype(np.longdouble)
        self._alpha_l = np.longdouble(prob.alpha)

    def evalF(self, u):
        # preserve extended precision when the Newton iterate carries it
        A = self.prob.A_host
        ul = np.asarray(u).astype(np.longdouble)
        prod = self._data_l * ul[A.indices]
        Au = np.add.reduceat(prod, A.indptr[:-1])
        Au[np.diff(A.indptr) == 0] = 0.0
        F_l = Au - self._alpha_l * np.exp(-ul)
        return F_l.astype(np.float64)

    def evalJ(self, u):
        p = self.prob
        uh = np.asarray(u, dtype=np.float64)
        bump = p.alpha * np.exp(-uh)
        J_host = p.A_host.copy()
        J_host.data[p._host_diag_pos] += bump.astype(J_host.data.dtype)
        d = p.A.diags.at[p._diag_idx, : p.n].add(
            jnp.asarray(bump, dtype=p.A.dtype))
        return J_host, DiaMatrix(d, p.A.offsets, p.A.shape)
