"""One-dispatch f64-residual refinement chains (refine.ir_solve_dd +
ops.spmv.ell_spmv_f64) and their factory wiring."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pysolvers_tpu.api import (PCG, GMRES, CommonSolverArgs,
                               _dd_chain_enabled)
from pysolvers_tpu.core import StopReason
from pysolvers_tpu.linear import refine
from pysolvers_tpu.linear.ilu import (ICPreconditionerType,
                                      ILUTPreconditionerType)
from pysolvers_tpu.problems import dh_test_problem, fd_laplacian_2d
from pysolvers_tpu.sparse.device import DiaMatrix, EllMatrix
from pysolvers_tpu.ops.spmv import ell_spmv_f64


class TestSplitGather:
    def test_matches_host_f64(self):
        H, _, _ = dh_test_problem(10)
        n = H.shape[0]
        A64 = EllMatrix.from_host_csr(H, dtype=np.float64)
        x = np.random.default_rng(0).random(n) * 2.0 - 1.0
        y = np.asarray(jax.jit(ell_spmv_f64)(A64,
                                                         jnp.asarray(x)))
        err = np.linalg.norm(y - H.matvec(x)) / np.linalg.norm(H.matvec(x))
        # two f32 planes carry x to ~2^-48; products/sums are f64
        assert err < 1e-13

    def test_wide_dynamic_range(self):
        """The f64 residual matvec stays accurate when components span
        magnitudes."""
        H = fd_laplacian_2d(12)
        n = H.shape[0]
        A64 = EllMatrix.from_host_csr(H, dtype=np.float64)
        x = np.random.default_rng(1).random(n) * np.logspace(
            -8, 8, n)
        y = np.asarray(ell_spmv_f64(A64, jnp.asarray(x)))
        ref = H.matvec(x)
        assert np.linalg.norm(y - ref) / np.linalg.norm(ref) < 1e-12


class TestIrSolveDd:
    def test_converges_to_1em10_ell(self):
        H, x_exact, b = dh_test_problem(11)
        A32 = EllMatrix.from_host_csr(H, dtype=np.float32)
        A64 = EllMatrix.from_host_csr(H, dtype=np.float64)
        x, st, _ = refine.ir_solve_dd(
            H.matvec, jnp.asarray(b, jnp.float64), A_lo=A32, A64=A64,
            tau=1e-10, inner_tau=1e-6, inner_maxiter=2000, method="cg")
        assert int(st.reason) == StopReason.CONVERGED
        rel = float(st.resid) / np.linalg.norm(b)
        assert rel <= 1e-10
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-7)

    def test_converges_dia(self):
        H = fd_laplacian_2d(24)
        n = H.shape[0]
        x_exact = np.random.default_rng(3).random(n)
        b = H.matvec(x_exact)
        A32 = DiaMatrix.from_host_csr(H, dtype=np.float32)
        A64 = DiaMatrix.from_host_csr(H, dtype=np.float64)
        x, st, _ = refine.ir_solve_dd(
            H.matvec, jnp.asarray(b, jnp.float64), A_lo=A32, A64=A64,
            tau=1e-10, inner_tau=1e-6, inner_maxiter=4000, method="cg")
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-7)

    def test_one_dispatch_suffices(self):
        """chain=4 accurate-residual steps reach 1e-10 in ONE device
        dispatch on a moderate problem (the whole point: the f32-residual
        chain saturates after one step; the f64 chain multiplies)."""
        H, _, b = dh_test_problem(10)
        A32 = EllMatrix.from_host_csr(H, dtype=np.float32)
        A64 = EllMatrix.from_host_csr(H, dtype=np.float64)
        calls = 0
        orig = refine._cached_dd_chain

        def counting(*a, **k):
            run = orig(*a, **k)

            def wrapped(*ra, **rk):
                nonlocal calls
                calls += 1
                return run(*ra, **rk)
            return wrapped

        refine._cached_dd_chain, cached = counting, refine._INNER_CACHE
        try:
            refine._INNER_CACHE = {}
            x, st, _ = refine.ir_solve_dd(
                H.matvec, jnp.asarray(b, jnp.float64), A_lo=A32, A64=A64,
                tau=1e-10, inner_tau=1e-6, inner_maxiter=2000,
                method="cg", chain=4)
        finally:
            refine._cached_dd_chain = orig
            refine._INNER_CACHE = cached
        assert int(st.reason) == StopReason.CONVERGED
        assert calls == 1

    def test_zero_rhs(self):
        H, _, _ = dh_test_problem(9)
        n = H.shape[0]
        A32 = EllMatrix.from_host_csr(H, dtype=np.float32)
        A64 = EllMatrix.from_host_csr(H, dtype=np.float64)
        x, st, _ = refine.ir_solve_dd(
            H.matvec, jnp.zeros(n, jnp.float64), A_lo=A32, A64=A64,
            tau=1e-10, method="cg")
        assert int(st.reason) == StopReason.CONVERGED
        assert float(jnp.linalg.norm(x)) == 0.0


class TestFactoryDd:
    def test_matches_legacy_path(self, monkeypatch):
        """Factory solves agree (to the tolerance) whether refinement runs
        the dd-chain or the per-pass host-residual loop."""
        H, x_exact, b = dh_test_problem(11)
        ctl = CommonSolverArgs(maxiter=400, tau=1e-10)

        st_dd = PCG(ctl, precond=ICPreconditionerType(),
                    precision="mixed").make_solver().solve(
                        H, jnp.asarray(b))
        monkeypatch.setenv("PST_DD_CHAIN", "0")
        st_legacy = PCG(ctl, precond=ICPreconditionerType(),
                        precision="mixed").make_solver().solve(
                            H, jnp.asarray(b))
        assert st_dd.success and st_legacy.success
        np.testing.assert_allclose(np.asarray(st_dd.soln), x_exact,
                                   atol=1e-7)
        np.testing.assert_allclose(np.asarray(st_legacy.soln), x_exact,
                                   atol=1e-7)

    def test_gmres_ilut_dd(self):
        H, x_exact, b = dh_test_problem(11)
        ctl = CommonSolverArgs(maxiter=400, tau=1e-10)
        st = GMRES(ctl, precond=ILUTPreconditionerType(),
                   precision="mixed").make_solver().solve(
                       H, jnp.asarray(b))
        assert st.success
        np.testing.assert_allclose(np.asarray(st.soln), x_exact, atol=1e-7)

    def test_env_switch(self, monkeypatch):
        assert _dd_chain_enabled()
        monkeypatch.setenv("PST_DD_CHAIN", "0")
        assert not _dd_chain_enabled()

    def test_rr_off_fallback(self, monkeypatch):
        """PST_RR=0 reverts the CG dd-chain to restart-per-pass
        corrections; the solve must still reach 1e-10."""
        monkeypatch.setenv("PST_RR", "0")
        H, x_exact, b = dh_test_problem(10)
        A32 = EllMatrix.from_host_csr(H, dtype=np.float32)
        A64 = EllMatrix.from_host_csr(H, dtype=np.float64)
        x, st, _ = refine.ir_solve_dd(
            H.matvec, jnp.asarray(b, jnp.float64), A_lo=A32, A64=A64,
            tau=1e-10, inner_tau=1e-6, inner_maxiter=2000, method="cg",
            chain=4)
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-7)
