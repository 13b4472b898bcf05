"""Mixed-precision iterative refinement tests."""
import numpy as np

import jax
import jax.numpy as jnp

from pysolvers_tpu.core import StopReason
from pysolvers_tpu.linear.refine import ir_solve
from pysolvers_tpu.ops import matvec
from pysolvers_tpu.problems import fd_laplacian_2d, dh_test_problem
from pysolvers_tpu.sparse import DiaMatrix, EllMatrix


class TestIterativeRefinement:
    def test_reaches_f64_tolerance_with_f32_inner(self):
        H = fd_laplacian_2d(12)
        A64 = DiaMatrix.from_host_csr(H)                       # f64
        A32 = DiaMatrix.from_host_csr(H, dtype=np.float32)
        rng = np.random.default_rng(0)
        x_exact = rng.random(144)
        b = jnp.asarray(H.matvec(x_exact))
        x, st, _ = ir_solve(lambda v: matvec(A64, v),
                            lambda v: matvec(A32, v), b,
                            tau=1e-12, inner_tau=1e-5, inner_maxiter=400)
        assert int(st.reason) == StopReason.CONVERGED
        r = np.linalg.norm(H.matvec(np.asarray(x)) - np.asarray(b))
        assert r <= 1e-12 * np.linalg.norm(np.asarray(b))
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-9)

    def test_gmres_inner(self):
        H, x_exact, b = dh_test_problem(8)
        A64 = EllMatrix.from_host_csr(H)
        A32 = EllMatrix.from_host_csr(H, dtype=np.float32)
        x, st, _ = ir_solve(lambda v: matvec(A64, v),
                            lambda v: matvec(A32, v), jnp.asarray(b),
                            tau=1e-10, inner_tau=1e-5, inner_maxiter=300,
                            method="gmres")
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-8)

    def test_jittable(self):
        H = fd_laplacian_2d(8)
        A64 = DiaMatrix.from_host_csr(H)
        A32 = DiaMatrix.from_host_csr(H, dtype=np.float32)
        b = jnp.asarray(H.matvec(np.ones(64)))

        @jax.jit
        def solve(A64, A32, b):
            return ir_solve(lambda v: matvec(A64, v),
                            lambda v: matvec(A32, v), b,
                            tau=1e-11, inner_maxiter=200)

        x, st, _ = solve(A64, A32, b)
        assert int(st.reason) == StopReason.CONVERGED


class TestHostIR:
    def test_host_variant_matches(self):
        from pysolvers_tpu.linear.refine import ir_solve_host
        H = fd_laplacian_2d(10)
        A64 = DiaMatrix.from_host_csr(H)
        A32 = DiaMatrix.from_host_csr(H, dtype=np.float32)
        b = jnp.asarray(H.matvec(np.random.default_rng(0).random(100)))
        x, st, _ = ir_solve_host(lambda v: matvec(A64, v),
                                 lambda v: matvec(A32, v), b,
                                 tau=1e-12, inner_tau=1e-5,
                                 inner_maxiter=300)
        assert int(st.reason) == StopReason.CONVERGED
        r = np.linalg.norm(H.matvec(np.asarray(x)) - np.asarray(b))
        assert r <= 1e-12 * np.linalg.norm(np.asarray(b))

    def test_host_residual_path(self):
        """Outer residuals on host (numpy f64), only the f32 inner
        solve on the device."""
        from pysolvers_tpu.linear.refine import ir_solve_host
        H = fd_laplacian_2d(10)
        A32 = DiaMatrix.from_host_csr(H, dtype=np.float32)
        b = H.matvec(np.random.default_rng(1).random(100))
        x, st, _ = ir_solve_host(lambda v: H.matvec(v),
                                 lambda v: matvec(A32, v), b,
                                 tau=1e-12, inner_tau=1e-5,
                                 inner_maxiter=300, host_residual=True)
        assert int(st.reason) == StopReason.CONVERGED
        r = np.linalg.norm(H.matvec(np.asarray(x)) - b)
        assert r <= 1e-12 * np.linalg.norm(b)
