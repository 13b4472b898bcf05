"""AMG hierarchy + V-cycle + preconditioner tests (SURVEY §4b)."""
import numpy as np

import jax.numpy as jnp

from pysolvers_tpu.core import SolverConfig, StopReason
from pysolvers_tpu.linear import cg_solve
from pysolvers_tpu.linear.amg import (AMG, AMGVCycle, build_aggregates,
                                      build_sa_hierarchy, sa_coarsen,
                                      build_device_hierarchy, v_cycle)
from pysolvers_tpu.ops import matvec
from pysolvers_tpu.problems import fd_laplacian_2d, dh_test_problem
from pysolvers_tpu.sparse import EllMatrix


class TestSASetup:
    def test_aggregates_cover_all_nodes(self):
        H = fd_laplacian_2d(10)
        agg = build_aggregates(H, 0.08)
        assert (agg >= 0).all()
        n_agg = agg.max() + 1
        assert 1 < n_agg < H.shape[0]

    def test_galerkin_operator_spd(self):
        H = fd_laplacian_2d(10)
        P, R, A_c = sa_coarsen(H, 0.08)
        Ac = A_c.to_dense()
        # coarse operator of an SPD matrix stays symmetric (up to roundoff
        # introduced by row-normalized restriction) and positive definite
        w = np.linalg.eigvals(Ac)
        assert (w.real > 0).all()
        assert P.shape == (H.shape[0], A_c.shape[0])
        assert R.shape == (A_c.shape[0], H.shape[0])

    def test_hierarchy_shapes(self):
        H = fd_laplacian_2d(12)
        mlh = build_sa_hierarchy(H, num_levels=3)
        assert mlh.n_levels >= 2
        # coarsest first
        sizes = [A.shape[0] for A in mlh.matrices]
        assert sizes == sorted(sizes)


class TestVCycle:
    def _converge(self, smoother):
        H = fd_laplacian_2d(12)
        n = H.shape[0]
        rng = np.random.default_rng(0)
        x_exact = rng.random(n)
        b = jnp.asarray(H.matvec(x_exact))
        mlh = build_sa_hierarchy(H, num_levels=3)
        h = build_device_hierarchy(mlh, smoother, 2, 2)
        x = jnp.zeros_like(b)
        A_dev = h.levels[-1].A_dev
        r0 = float(jnp.linalg.norm(b))
        for _ in range(60):
            x = v_cycle(h, b, x)
            r = float(jnp.linalg.norm(b - matvec(A_dev, x)))
            if r <= 1e-10 * r0:
                break
        assert r <= 1e-10 * r0, f"{smoother}: resid {r / r0:.2e}"
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-6)

    def test_vcycle_gs(self):
        self._converge("gs")

    def test_vcycle_jacobi(self):
        self._converge("jacobi")

    def test_vcycle_chebyshev(self):
        self._converge("chebyshev")

    def test_vcycle_sgs(self):
        self._converge("sgs")

    def test_sgs_vcycle_is_symmetric(self):
        """With the symmetric-GS smoother and nu_pre == nu_post, the
        V-cycle preconditioner operator is symmetric (SPD A) — the
        property that makes it safe inside (rr-)PCG, unlike the
        one-directional "gs" cycle."""
        H = fd_laplacian_2d(7)          # n = 49: build V explicitly
        n = H.shape[0]
        mlh = build_sa_hierarchy(H, num_levels=2)

        def cycle_matrix(smoother):
            h = build_device_hierarchy(mlh, smoother, 2, 2,
                                       dtype=np.float64)
            cols = []
            for i in range(n):
                e = jnp.zeros((n,), jnp.float64).at[i].set(1.0)
                cols.append(np.asarray(v_cycle(h, e, jnp.zeros_like(e))))
            return np.stack(cols, axis=1)

        V = cycle_matrix("sgs")
        asym = np.abs(V - V.T).max() / np.abs(V).max()
        assert asym < 1e-12, f"sgs V-cycle asymmetry {asym:.2e}"
        # eigenvalues of the SPD preconditioner stay positive
        w = np.linalg.eigvalsh(0.5 * (V + V.T))
        assert (w > 0).all()
        # contrast: the one-directional GS cycle is measurably nonsymmetric
        Vgs = cycle_matrix("gs")
        assert np.abs(Vgs - Vgs.T).max() / np.abs(Vgs).max() > 1e-8


class TestAMGSolverShell:
    def test_amg_vcycle_solver(self):
        H = fd_laplacian_2d(12)
        rng = np.random.default_rng(1)
        x_exact = rng.random(H.shape[0])
        b = H.matvec(x_exact)
        solver = AMGVCycle(SolverConfig(maxiter=60, tau=1e-10),
                           num_levels=3).make_solver()
        st = solver.solve(H, b)
        assert st.success
        np.testing.assert_allclose(np.asarray(st.soln), x_exact, atol=1e-6)

    def test_hierarchy_frozen_reuse(self):
        H = fd_laplacian_2d(10)
        b = np.random.default_rng(2).random(100)
        solver = AMGVCycle(SolverConfig(maxiter=50, tau=1e-10),
                           num_levels=2).make_solver()
        st1 = solver.solve(H, b)
        solver.freeze_matrix()
        h_before = solver._hierarchy
        st2 = solver.solve(H, 2.0 * b)
        assert solver._hierarchy is h_before
        assert st1.success and st2.success

    def test_amg_preconditioned_cg(self):
        H, x_exact, b = dh_test_problem(10)
        A = EllMatrix.from_host_csr(H)
        mv = lambda v: matvec(A, v)
        _, st0, _ = cg_solve(mv, jnp.asarray(b), maxiter=500, tau=1e-10)
        M = AMG(num_iters=2, num_levels=2).form(H)
        x, st1, _ = cg_solve(mv, jnp.asarray(b), maxiter=500, tau=1e-10,
                             precond=M.apply_right)
        assert int(st1.reason) == StopReason.CONVERGED
        assert int(st1.k) < int(st0.k)
        np.testing.assert_allclose(np.asarray(x), x_exact, atol=1e-6)


class TestGalerkinSymmetry:
    def test_sa_coarse_operators_symmetric_unstructured(self):
        """R = P^T (unnormalized) must produce SYMMETRIC Galerkin coarse
        operators on unstructured aggregates.  The row-sum-normalized
        restriction (reference MLHierarchy.py:60-78) made A_c 10-20%
        asymmetric on unstructured FEM and the V-cycle stopped being a
        valid SPD preconditioner — PCG at n=4.2M stalled at rel 4e-2
        (amg.sa_coarsen docstring)."""
        import numpy as np
        from pysolvers_tpu.problems.fem import fem_poisson_2d_unstructured
        from pysolvers_tpu.linear.amg import build_sa_hierarchy

        A = fem_poisson_2d_unstructured(49, seed=3)
        mlh = build_sa_hierarchy(A, num_levels=3)
        assert len(mlh.matrices) >= 2
        for k, M in enumerate(mlh.matrices):
            Mt = M.transpose()
            assert np.array_equal(Mt.indptr, M.indptr)
            assert np.array_equal(Mt.indices, M.indices)
            rel = np.abs(Mt.data - M.data).max() / np.abs(M.data).max()
            assert rel < 1e-12, f"level {k} asymmetric: {rel}"
        for P, R in zip(mlh.prolongators, mlh.restrictions):
            Pt = P.transpose()
            assert np.array_equal(Pt.indptr, R.indptr)
            assert np.array_equal(Pt.indices, R.indices)
            np.testing.assert_allclose(Pt.data, R.data, rtol=0, atol=0)
