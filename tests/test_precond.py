"""Preconditioner + triangular-solve tests vs scipy oracles (SURVEY §4a/c)."""
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax.numpy as jnp

from pysolvers_tpu.core import StopReason
from pysolvers_tpu.linear import cg_solve, gmres_solve
from pysolvers_tpu.linear.ilu import (ilut_factor, ict_factor,
                                      ILUTPreconditionerType,
                                      ICPreconditionerType)
from pysolvers_tpu.linear.preconditioner import (JacobiPreconditionerType,
                                                 ChebyshevPreconditionerType,
                                                 IdentityPreconditionerType)
from pysolvers_tpu.ops import matvec
from pysolvers_tpu.ops.trisolve import (build_trisolve_plan, trisolve,
                                        trisolve_jacobi)
from pysolvers_tpu.problems import fd_laplacian_2d, dh_test_problem
from pysolvers_tpu.sparse import EllMatrix, HostCSR


def to_host(S):
    S = S.tocsr()
    S.sort_indices()
    return HostCSR(S.indptr.astype(np.int64), S.indices.astype(np.int32),
                   S.data.copy(), S.shape)


class TestTrisolve:
    def test_lower_oracle(self):
        rng = np.random.default_rng(0)
        S = sp.random(60, 60, 0.1, random_state=rng).tolil()
        S.setdiag(rng.random(60) + 1.0)
        L = to_host(sp.tril(S.tocsr()))
        plan = build_trisolve_plan(L, lower=True)
        b = rng.random(60)
        x = trisolve(plan, jnp.asarray(b))
        ref = spla.spsolve_triangular(sp.tril(S.tocsr()).tocsr(), b, lower=True)
        np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-10)

    def test_upper_oracle(self):
        rng = np.random.default_rng(1)
        S = sp.random(45, 45, 0.12, random_state=rng).tolil()
        S.setdiag(rng.random(45) + 1.0)
        U = to_host(sp.triu(S.tocsr()))
        plan = build_trisolve_plan(U, lower=False)
        b = rng.random(45)
        x = trisolve(plan, jnp.asarray(b))
        ref = spla.spsolve_triangular(sp.triu(S.tocsr()).tocsr(), b,
                                      lower=False)
        np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-10)

    def test_unit_diag(self):
        rng = np.random.default_rng(2)
        S = sp.tril(sp.random(30, 30, 0.15, random_state=rng), k=-1).tolil()
        S.setdiag(1.0)
        L = to_host(S.tocsr())
        plan = build_trisolve_plan(L, lower=True, unit_diag=True)
        b = rng.random(30)
        x = trisolve(plan, jnp.asarray(b))
        ref = spla.spsolve_triangular(S.tocsr(), b, lower=True,
                                      unit_diagonal=True)
        np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-10)

    def test_jacobi_sweeps_converge(self):
        L = to_host(sp.tril(fd_laplacian_2d(6).to_dense() * 0
                            + np.tril(fd_laplacian_2d(6).to_dense())))
        plan = build_trisolve_plan(L, lower=True)
        b = np.random.default_rng(3).random(36)
        x_exact = trisolve(plan, jnp.asarray(b))
        x_approx = trisolve_jacobi(plan, jnp.asarray(b), sweeps=40)
        np.testing.assert_allclose(np.asarray(x_approx), np.asarray(x_exact),
                                   atol=1e-10)


class TestILUT:
    def test_exact_when_no_dropping(self):
        """With drop_tol=0 and unlimited fill, ILUT == exact LU (no pivot)."""
        H = fd_laplacian_2d(5)
        L, U = ilut_factor(H, drop_tol=0.0, fill_factor=1000.0)
        A2 = L.matmat(U)
        np.testing.assert_allclose(A2.to_dense(), H.to_dense(), atol=1e-8)

    def test_ic_exact_cholesky(self):
        H = fd_laplacian_2d(5)
        Lc = ict_factor(H, drop_tol=0.0, fill_factor=1000.0)
        A2 = Lc.matmat(Lc.transpose())
        np.testing.assert_allclose(A2.to_dense(), H.to_dense(), atol=1e-8)

    def test_ilut_reduces_gmres_iters(self):
        H, x_exact, b = dh_test_problem(9)
        A = EllMatrix.from_host_csr(H)
        mv = lambda v: matvec(A, v)
        _, st0, _ = gmres_solve(mv, jnp.asarray(b), maxiter=300, tau=1e-10)
        M = ILUTPreconditionerType(1e-3, 15).form(H)
        x, st1, _ = gmres_solve(mv, jnp.asarray(b), maxiter=300, tau=1e-10,
                                precond=M.apply_right)
        assert int(st1.reason) == StopReason.CONVERGED
        assert int(st1.k) < int(st0.k)
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-6)

    def test_ic_reduces_cg_iters(self):
        H, x_exact, b = dh_test_problem(9)
        A = EllMatrix.from_host_csr(H)
        mv = lambda v: matvec(A, v)
        _, st0, _ = cg_solve(mv, jnp.asarray(b), maxiter=500, tau=1e-10)
        M = ICPreconditionerType(1e-3, 15).form(H)
        x, st1, _ = cg_solve(mv, jnp.asarray(b), maxiter=500, tau=1e-10,
                             precond=M.apply_right)
        assert int(st1.reason) == StopReason.CONVERGED
        assert int(st1.k) < int(st0.k)
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-6)


class TestMatrixFreePrecs:
    def test_identity(self):
        M = IdentityPreconditionerType().form()
        v = jnp.arange(5.0)
        np.testing.assert_allclose(np.asarray(M.apply_left(v)), np.asarray(v))
        assert M.is_identity

    def test_chebyshev_accelerates_cg(self):
        H = fd_laplacian_2d(14)
        A = EllMatrix.from_host_csr(H)
        mv = lambda v: matvec(A, v)
        b = jnp.asarray(np.random.default_rng(5).random(196))
        _, st0, _ = cg_solve(mv, b, maxiter=500, tau=1e-10)
        M = ChebyshevPreconditionerType(degree=4).form(H, A)
        x, st1, _ = cg_solve(mv, b, maxiter=500, tau=1e-10,
                             precond=M.apply_right)
        assert int(st1.reason) == StopReason.CONVERGED
        assert int(st1.k) < int(st0.k)

    def test_jacobi_converges(self):
        H, x_exact, b = dh_test_problem(7)
        A = EllMatrix.from_host_csr(H)
        M = JacobiPreconditionerType().form(H)
        x, st, _ = cg_solve(lambda v: matvec(A, v), jnp.asarray(b),
                            maxiter=500, tau=1e-10, precond=M.apply_right)
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-6)


class TestJacobiTrisolveMode:
    def test_ilut_jacobi_sweeps_preconditions(self):
        from pysolvers_tpu.linear.ilu import ILUTPreconditionerType
        H, x_exact, b = dh_test_problem(9)
        A = EllMatrix.from_host_csr(H)
        mv = lambda v: matvec(A, v)
        _, st0, _ = gmres_solve(mv, jnp.asarray(b), maxiter=300, tau=1e-10)
        M = ILUTPreconditionerType(1e-3, 15, trisolve_mode="jacobi",
                                  sweeps=10).form(H)
        x, st1, _ = gmres_solve(mv, jnp.asarray(b), maxiter=300, tau=1e-10,
                                precond=M.apply_right)
        assert int(st1.reason) == StopReason.CONVERGED
        assert int(st1.k) < int(st0.k)
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-6)


class TestBwsSweepTrisolveMode:
    def test_ic_jacobi_bws_preconditions(self):
        """The BWS sweep mode is gone: "jacobi" sweeps are its plain-JAX
        replacement and still precondition an RCM-ordered problem, and
        the old mode name is refused."""
        from pysolvers_tpu.linear.ilu import ICPreconditionerType
        H, x_exact, b = dh_test_problem(9)
        perm = H.rcm_perm()
        Hp = H.permute_symmetric(perm)
        Hp32 = HostCSR(Hp.indptr, Hp.indices, Hp.data.astype(np.float32),
                       Hp.shape)
        M = ICPreconditionerType(1e-3, 15, trisolve_mode="jacobi",
                                 sweeps=10).form(Hp32)
        A = EllMatrix.from_host_csr(Hp32, dtype=np.float32)
        bp = jnp.asarray(b[perm].astype(np.float32))
        mv = lambda v: matvec(A, v)
        _, st0, _ = cg_solve(mv, bp, maxiter=500, tau=1e-5)
        x, st1, _ = cg_solve(mv, bp, maxiter=500, tau=1e-5,
                             precond=M.apply_right)
        assert int(st1.reason) == StopReason.CONVERGED
        assert int(st1.k) < int(st0.k)
        with pytest.raises(ValueError, match="trisolve_mode"):
            ICPreconditionerType(trisolve_mode="jacobi_bws").form(Hp32)
