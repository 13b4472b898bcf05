"""Mixed-precision route through the factory API (api.py precision="mixed").

PCG/GMRES factories with precision="mixed" run the inner Krylov in f32 on
the device kernels with f64 residual refinement — the f32 route to the
reference's tolerances.  The f32 operator is a traced pytree argument
of one cached inner jit, so Newton steps that change Jacobian VALUES (not
structure) reuse the compilation (refine._cached_inner_op).
"""
import numpy as np
import jax.numpy as jnp

from pysolvers_tpu import (CommonSolverArgs, NewtonSolver, PCG, GMRES,
                           SolverConfig)
from pysolvers_tpu.linear.ilu import (ICPreconditionerType,
                                      ILUTPreconditionerType)
from pysolvers_tpu.linear.amg import AMG
from pysolvers_tpu.problems import Bratu2D, dh_test_problem
from pysolvers_tpu.problems.laplacian import fd_laplacian_2d


class TestMixedFactory:
    def test_pcg_mixed_dh(self):
        A, x_exact, b = dh_test_problem(10)
        f = PCG(CommonSolverArgs(maxiter=500, tau=1e-10),
                precond=ICPreconditionerType(), precision="mixed")
        st = f.make_solver().solve(A, b)
        assert st.success
        err = np.linalg.norm(np.asarray(st.soln) - x_exact)
        assert err / np.linalg.norm(x_exact) < 1e-8

    def test_gmres_mixed_dh(self):
        A, x_exact, b = dh_test_problem(10)
        f = GMRES(CommonSolverArgs(maxiter=500, tau=1e-10),
                  precond=ILUTPreconditionerType(), precision="mixed")
        st = f.make_solver().solve(A, b)
        assert st.success
        err = np.linalg.norm(np.asarray(st.soln) - x_exact)
        assert err / np.linalg.norm(x_exact) < 1e-8

    def test_pcg_mixed_dia_laplacian(self):
        A = fd_laplacian_2d(24)
        rng = np.random.default_rng(0)
        x_exact = rng.random(A.shape[0])
        b = A.matvec(x_exact)
        f = PCG(CommonSolverArgs(maxiter=3000, tau=1e-10),
                precision="mixed")
        st = f.make_solver().solve(A, b)
        assert st.success
        err = np.linalg.norm(np.asarray(st.soln) - x_exact)
        assert err / np.linalg.norm(x_exact) < 1e-7

    def test_bad_precision_rejected(self):
        import pytest
        with pytest.raises(ValueError):
            PCG(precision="f16")

    def test_newton_bratu_mixed(self):
        """Reference FDBratu2D.py:36-48 config with mixed-precision inner
        PCG+AMG — the mixed Newton route (f64 outer on host, f32
        inner on device kernels)."""
        prob = Bratu2D(m=20, alpha=0.5, fmt="dia")
        inner = PCG(CommonSolverArgs(maxiter=400, tau=1e-12),
                    precond=AMG(num_iters=5, num_levels=2),
                    precision="mixed")
        ns = NewtonSolver(SolverConfig(maxiter=30, tau=1e-12),
                          solver=inner, min_lin_tol=1e-6, freeze_prec=True)
        st = ns.solve(prob, jnp.zeros(prob.n, dtype=jnp.float64))
        assert st.success
        Fn = float(jnp.linalg.norm(prob.evalF(st.soln.astype(jnp.float64))))
        assert Fn <= 1e-10

    def test_mixed_inner_jit_reused_across_jacobians(self):
        """Same-structure Jacobians with different values AND re-formed
        same-structure preconditioners (repeated Newton solves) must share
        ONE compiled inner graph (operator + prec state are traced
        arguments — refine._cached_inner_pair)."""
        from pysolvers_tpu.linear import refine
        prob = Bratu2D(m=12, alpha=0.5, fmt="dia")
        inner = PCG(CommonSolverArgs(maxiter=200, tau=1e-8),
                    precond=AMG(num_iters=3, num_levels=2),
                    precision="mixed")
        ns = NewtonSolver(SolverConfig(maxiter=20, tau=1e-10),
                          solver=inner, min_lin_tol=1e-6, freeze_prec=True)
        before = len(refine._INNER_CACHE)
        st = ns.solve(prob, jnp.zeros(prob.n, dtype=jnp.float64))
        assert st.success
        # a SECOND Newton solve re-forms the AMG preconditioner — the
        # traced-pair route must still hit the same cache entry
        st2 = ns.solve(prob, jnp.zeros(prob.n, dtype=jnp.float64))
        assert st2.success
        # at most the chain-1 and chain-2 graph variants — NOT one per
        # Newton step or per solve
        assert len(refine._INNER_CACHE) - before <= 2
        # traced-state routes: dd-chain (default) or the pair route
        new_keys = [k for k in refine._INNER_CACHE
                    if k[0] in ("pair", "ddchain")]
        assert len(new_keys) >= 1


class TestMixedGmresOptions:
    def test_cgs2_and_flexible_thread_through(self):
        """GMRES(orthog='cgs2') / flexible must reach the refinement's
        inner solves (they used to be silently dropped)."""
        import numpy as np
        from pysolvers_tpu.api import CommonSolverArgs, GMRES
        from pysolvers_tpu.problems import dh_test_problem
        H, x_exact, b = dh_test_problem(10)
        for kw in (dict(orthog="cgs2"), dict(flexible=True)):
            st = GMRES(CommonSolverArgs(maxiter=600, tau=1e-10),
                       precision="mixed", restart=60, **kw) \
                .make_solver().solve(H, b)
            assert st.success, kw
            assert np.linalg.norm(np.asarray(st.soln) - x_exact) <= 1e-6
