"""Krylov solver convergence tests (SURVEY §4b: manufactured solutions)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pysolvers_tpu.core import StopReason
from pysolvers_tpu.linear import cg_solve, gmres_solve
from pysolvers_tpu.ops import matvec
from pysolvers_tpu.problems import fd_laplacian_1d, fd_laplacian_2d, dh_test_problem
from pysolvers_tpu.sparse import EllMatrix, DiaMatrix


def manufacture(H, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random(H.shape[0])
    return jnp.asarray(x), jnp.asarray(H.matvec(x))


class TestCG:
    def test_laplacian_1d_to_1e10(self):
        H = fd_laplacian_1d(128)
        A = DiaMatrix.from_host_csr(H)
        x_exact, b = manufacture(H)
        x, st, hist = cg_solve(lambda v: matvec(A, v), b, maxiter=400, tau=1e-10)
        assert int(st.reason) == StopReason.CONVERGED
        r = np.linalg.norm(H.matvec(np.asarray(x)) - np.asarray(b))
        assert r <= 1e-10 * np.linalg.norm(np.asarray(b))
        np.testing.assert_allclose(np.asarray(x), np.asarray(x_exact),
                                   atol=1e-6)

    def test_laplacian_2d_ell(self):
        H = fd_laplacian_2d(12)
        A = EllMatrix.from_host_csr(H)
        x_exact, b = manufacture(H, seed=1)
        x, st, _ = cg_solve(lambda v: matvec(A, v), b, maxiter=500, tau=1e-10)
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x), np.asarray(x_exact), atol=1e-6)

    def test_zero_rhs_returns_zero(self):
        H = fd_laplacian_1d(16)
        A = DiaMatrix.from_host_csr(H)
        b = jnp.zeros(16, dtype=jnp.float64)
        x, st, _ = cg_solve(lambda v: matvec(A, v), b, maxiter=10, tau=1e-10)
        assert int(st.reason) == StopReason.CONVERGED
        assert int(st.k) == 0
        np.testing.assert_allclose(np.asarray(x), 0.0)

    def test_maxiter_flag(self):
        H = fd_laplacian_2d(16)
        A = EllMatrix.from_host_csr(H)
        _, b = manufacture(H, seed=2)
        x, st, _ = cg_solve(lambda v: matvec(A, v), b, maxiter=3, tau=1e-14)
        assert int(st.reason) == StopReason.MAXITER
        assert int(st.k) == 3

    def test_jacobi_preconditioner(self):
        H = fd_laplacian_2d(10)
        A = EllMatrix.from_host_csr(H)
        dinv = jnp.asarray(1.0 / H.diagonal())
        _, b = manufacture(H, seed=3)
        mv = lambda v: matvec(A, v)
        x1, st1, _ = cg_solve(mv, b, maxiter=300, tau=1e-10)
        x2, st2, _ = cg_solve(mv, b, maxiter=300, tau=1e-10,
                              precond=lambda v: dinv * v)
        assert int(st2.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-6)

    def test_dh_matrix(self):
        H, x_exact, b = dh_test_problem(8)
        A = EllMatrix.from_host_csr(H)
        x, st, _ = cg_solve(lambda v: matvec(A, v), jnp.asarray(b),
                            maxiter=600, tau=1e-10)
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-6)

    def test_jit_wrapped(self):
        H = fd_laplacian_1d(64)
        A = DiaMatrix.from_host_csr(H)
        _, b = manufacture(H, seed=4)

        @jax.jit
        def solve(A, b):
            return cg_solve(lambda v: matvec(A, v), b, maxiter=200, tau=1e-10)

        x, st, _ = solve(A, b)
        assert int(st.reason) == StopReason.CONVERGED


class TestGMRES:
    def test_laplacian_1d(self):
        H = fd_laplacian_1d(64)
        A = DiaMatrix.from_host_csr(H)
        x_exact, b = manufacture(H, seed=5)
        x, st, _ = gmres_solve(lambda v: matvec(A, v), b, maxiter=100,
                               tau=1e-10)
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x), np.asarray(x_exact), atol=1e-6)

    def test_nonsymmetric(self):
        # convection-diffusion–like perturbation of the Laplacian
        H = fd_laplacian_1d(48)
        rows, cols, vals = H.to_coo()
        vals = vals + np.where(cols == rows + 1, 15.0 * (48 + 1), 0.0)
        from pysolvers_tpu.sparse import HostCSR
        Hn = HostCSR.from_coo(rows, cols, vals, H.shape, sum_duplicates=False)
        A = EllMatrix.from_host_csr(Hn)
        x_exact = np.random.default_rng(6).random(48)
        b = jnp.asarray(Hn.matvec(x_exact))
        x, st, _ = gmres_solve(lambda v: matvec(A, v), b, maxiter=60, tau=1e-12)
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-7)

    def test_restart(self):
        H = fd_laplacian_2d(8)
        A = EllMatrix.from_host_csr(H)
        x_exact, b = manufacture(H, seed=7)
        x, st, _ = gmres_solve(lambda v: matvec(A, v), b, maxiter=400,
                               restart=20, tau=1e-10)
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x), np.asarray(x_exact), atol=1e-5)

    def test_dh_gmres(self):
        H, x_exact, b = dh_test_problem(6)
        A = EllMatrix.from_host_csr(H)
        x, st, _ = gmres_solve(lambda v: matvec(A, v), jnp.asarray(b),
                               maxiter=80, tau=1e-10)
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-6)

    def test_identity_converges_one_iter(self):
        n = 32
        b = jnp.asarray(np.random.default_rng(8).random(n))
        x, st, _ = gmres_solve(lambda v: v, b, maxiter=10, tau=1e-12)
        assert int(st.reason) == StopReason.CONVERGED
        assert int(st.k) <= 2
        np.testing.assert_allclose(np.asarray(x), np.asarray(b), atol=1e-12)


class TestFGMRES:
    def test_flexible_with_inner_solver_preconditioner(self):
        """FGMRES tolerates an iteration-varying preconditioner (inner CG)."""
        H = fd_laplacian_2d(10)
        A = EllMatrix.from_host_csr(H)
        mv = lambda v: matvec(A, v)

        def inner_prec(r):
            # truncated inner CG as preconditioner (varies with r)
            z, _, _ = cg_solve(mv, r, maxiter=5, tau=1e-12)
            return z

        x_exact = np.random.default_rng(11).random(100)
        b = jnp.asarray(H.matvec(x_exact))
        x, st, _ = gmres_solve(mv, b, maxiter=100, tau=1e-10,
                               precond=inner_prec, flexible=True)
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-6)

    def test_flexible_matches_plain_for_fixed_prec(self):
        H = fd_laplacian_2d(8)
        A = EllMatrix.from_host_csr(H)
        mv = lambda v: matvec(A, v)
        dinv = jnp.asarray(1.0 / H.diagonal())
        b = jnp.asarray(np.random.default_rng(12).random(64))
        prec = lambda v: dinv * v
        x1, st1, _ = gmres_solve(mv, b, maxiter=80, tau=1e-10, precond=prec)
        x2, st2, _ = gmres_solve(mv, b, maxiter=80, tau=1e-10, precond=prec,
                                 flexible=True)
        assert int(st1.reason) == int(st2.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-8)


class TestCGMulti:
    """Blocked multi-RHS CG: per-column semantics match cg_solve while one
    SpMM pass per iteration serves every column."""

    def _problem(self, k_rhs=4, lev=9):
        from pysolvers_tpu.problems import dh_test_problem
        H, _, _ = dh_test_problem(lev)
        n = H.shape[0]
        rng = np.random.default_rng(7)
        X_exact = rng.random((n, k_rhs))
        B = np.stack([H.matvec(X_exact[:, j]) for j in range(k_rhs)],
                     axis=1)
        A = EllMatrix.from_host_csr(H)
        return H, A, X_exact, B

    def test_matches_per_column_cg(self):
        from pysolvers_tpu.linear.krylov import cg_solve_multi
        from pysolvers_tpu.ops import matmat
        H, A, X_exact, B = self._problem()
        X, st, _ = cg_solve_multi(lambda V: matmat(A, V), jnp.asarray(B),
                                  maxiter=600, tau=1e-10)
        assert (np.asarray(st.reason) == StopReason.CONVERGED).all()
        for j in range(B.shape[1]):
            xj, stj, _ = cg_solve(lambda v: matvec(A, v),
                                  jnp.asarray(B[:, j]), maxiter=600,
                                  tau=1e-10)
            # identical recurrence per column (same dots, same alphas)
            assert int(st.k[j]) == int(stj.k)
            np.testing.assert_allclose(np.asarray(X[:, j]), np.asarray(xj),
                                       rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.asarray(X), X_exact, atol=1e-6)

    def test_mixed_convergence_and_trivial_column(self):
        """Columns converge at different iterations; a zero column is
        CONVERGED immediately with x = 0; finished columns stay frozen."""
        from pysolvers_tpu.linear.krylov import cg_solve_multi
        from pysolvers_tpu.ops import matmat
        H, A, X_exact, B = self._problem(k_rhs=3)
        B = B.copy()
        B[:, 1] = 0.0                        # trivial column
        B[:, 2] *= 1e-8                      # same conditioning, scaled
        X, st, _ = cg_solve_multi(lambda V: matmat(A, V), jnp.asarray(B),
                                  maxiter=600, tau=1e-10)
        assert (np.asarray(st.reason) == StopReason.CONVERGED).all()
        assert int(st.k[1]) == 0
        np.testing.assert_allclose(np.asarray(X[:, 1]), 0.0, atol=0)
        for j in (0, 2):
            rn = np.linalg.norm(B[:, j] - H.matvec(np.asarray(X[:, j])))
            assert rn <= 1e-10 * np.linalg.norm(B[:, j]) * 1.01

    def test_preconditioned_block(self):
        """Jacobi preconditioning applied blockwise cuts iterations for
        every column."""
        from pysolvers_tpu.linear.krylov import cg_solve_multi
        from pysolvers_tpu.ops import matmat
        H, A, X_exact, B = self._problem()
        d = jnp.asarray(1.0 / H.diagonal())
        Bj = jnp.asarray(B)
        X0s, st0, _ = cg_solve_multi(lambda V: matmat(A, V), Bj,
                                     maxiter=600, tau=1e-10)
        X1s, st1, _ = cg_solve_multi(lambda V: matmat(A, V), Bj,
                                     maxiter=600, tau=1e-10,
                                     precond=lambda V: d[:, None] * V)
        assert (np.asarray(st1.reason) == StopReason.CONVERGED).all()
        assert (np.asarray(st1.k) <= np.asarray(st0.k)).all()
        np.testing.assert_allclose(np.asarray(X1s), X_exact, atol=1e-6)


class TestCGResidualReplacement:
    """cg_solve_rr: f32 CG + periodic f64 residual replacement converges to
    f64-grade TRUE residuals in near-f64 iteration counts (no restarts)."""

    def _setup(self, lev=11):
        from pysolvers_tpu.problems import dh_test_problem
        from pysolvers_tpu.ops.spmv import ell_spmv_f64
        H, x_exact, b = dh_test_problem(lev)
        A32 = EllMatrix.from_host_csr(H, dtype=np.float32)
        A64 = EllMatrix.from_host_csr(H, dtype=np.float64)
        bn = np.linalg.norm(b)
        b_hi = jnp.asarray(b / bn)
        mv = lambda v: matvec(A32, v)
        mv_hi = lambda v: ell_spmv_f64(A64, v)
        return H, x_exact, b, bn, b_hi, mv, mv_hi

    def test_true_residual_reaches_f64_grade(self):
        from pysolvers_tpu.linear.krylov import cg_solve_rr
        H, _, b, bn, b_hi, mv, mv_hi = self._setup()
        x64, st, _ = cg_solve_rr(mv, b_hi, mv_hi=mv_hi, maxiter=3000,
                                 tau=1e-10)
        assert int(st.reason) == StopReason.CONVERGED
        # the reported residual must be HONEST: true f64 residual agrees
        true = np.linalg.norm(np.asarray(b_hi) - H.matvec(np.asarray(x64)))
        assert true <= 2e-10
        assert abs(true - float(st.resid)) <= 0.5 * max(true, 1e-14) + 1e-12

    def test_beats_plain_f32_floor(self):
        """Plain f32 CG's true residual stalls at ~eps32*kappa; rr goes
        through the floor in one continuous solve."""
        from pysolvers_tpu.linear.krylov import cg_solve_rr
        H, _, b, bn, b_hi, mv, mv_hi = self._setup()
        x32, _, _ = cg_solve(mv, b_hi.astype(jnp.float32), maxiter=3000,
                             tau=1e-12)
        floor32 = np.linalg.norm(np.asarray(b_hi)
                                 - H.matvec(np.asarray(x32, np.float64)))
        x64, st, _ = cg_solve_rr(mv, b_hi, mv_hi=mv_hi, maxiter=3000,
                                 tau=1e-10)
        true = np.linalg.norm(np.asarray(b_hi) - H.matvec(np.asarray(x64)))
        assert true < floor32 * 1e-2

    def test_divergence_guard_nonsymmetric_precond(self):
        """PCG is not a descent method with a NONSYMMETRIC M once the
        residual sits at the f32 noise floor (measured divergence to
        1e+25 pre-guard on a near-converged Newton step with a
        one-directional-GS AMG V-cycle).  The guard must exit with the
        best replaced iterate — never a blowup."""
        from pysolvers_tpu.linear.krylov import cg_solve_rr
        H, _, b, bn, b_hi, mv, mv_hi = self._setup(lev=9)
        # strongly nonsymmetric "preconditioner": one damped-Jacobi-ish
        # sweep skewed by a triangular mask of A — deliberately NOT SPD
        A32 = EllMatrix.from_host_csr(H, dtype=np.float32)
        skew = jnp.asarray(np.triu(H.to_dense()).astype(np.float32))
        papply = lambda r: r - 0.4 * (skew @ r) / jnp.float32(
            H.data.max())
        # tolerance far below what this M lets f32 CG reach
        x64, st, _ = cg_solve_rr(mv, b_hi, mv_hi=mv_hi, maxiter=600,
                                 tau=1e-14, precond=papply)
        true = np.linalg.norm(np.asarray(b_hi)
                              - H.matvec(np.asarray(x64)))
        # exit state may be STALL/MAXITER/BREAKDOWN — but the returned
        # iterate must be the best verified one, not a diverged x
        assert np.isfinite(true)
        assert true <= 1.0          # never worse than the zero iterate
        assert float(st.resid) <= 1.0

    def test_sgs_amg_precond_is_rr_safe(self):
        """The symmetric-GS AMG V-cycle (SPD operator) composes cleanly
        with residual-replacement CG: clean CONVERGED to 1e-10 — the
        positive counterpart of the nonsymmetric-guard test above."""
        from pysolvers_tpu.linear.amg import AMG
        from pysolvers_tpu.linear.krylov import cg_solve_rr
        H, _, b, bn, b_hi, mv, mv_hi = self._setup(lev=10)
        M = AMG(num_iters=2, num_levels=2, smoother="sgs").form(H)
        x64, st, _ = cg_solve_rr(mv, b_hi, mv_hi=mv_hi, maxiter=400,
                                 tau=1e-10, precond=lambda r:
                                 M.apply_right(r).astype(jnp.float32))
        assert int(st.reason) == StopReason.CONVERGED
        true = np.linalg.norm(np.asarray(b_hi) - H.matvec(np.asarray(x64)))
        assert true <= 2e-10

    def test_preconditioned_iteration_count_near_f64(self):
        """With IC(t), rr lands within ~1.5x of the all-f64 CG count —
        the restart-per-pass refinement chain costs ~2x (VERDICT r2
        'remaining' item: close the 71-vs-20 gap)."""
        from pysolvers_tpu.linear.ilu import ICPreconditionerType
        from pysolvers_tpu.linear.krylov import cg_solve_rr
        H, _, b, bn, b_hi, mv, mv_hi = self._setup()
        papply = ICPreconditionerType().form(H).apply_right
        x_oracle, st_oracle, _ = cg_solve(mv_hi, b_hi, maxiter=400,
                                          tau=1e-10, precond=lambda v:
                                          papply(v.astype(jnp.float32))
                                          .astype(jnp.float64))
        x64, st, _ = cg_solve_rr(mv, b_hi, mv_hi=mv_hi, maxiter=400,
                                 tau=1e-10, precond=papply)
        assert int(st.reason) == StopReason.CONVERGED
        assert int(st.k) <= int(st_oracle.k) * 1.5 + 3
