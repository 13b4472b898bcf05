"""Distributed SpMV + solver tests on the virtual 8-device CPU mesh
(SURVEY §4d)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pysolvers_tpu.core import StopReason
from pysolvers_tpu.linear import cg_solve
from pysolvers_tpu.parallel import (make_mesh, shard_dia, shard_ell,
                                    dist_dia_spmv, dist_ell_spmv,
                                    pad_vector_dia, pad_vector_ell)
from pysolvers_tpu.problems import fd_laplacian_1d, fd_laplacian_2d, dh_test_problem


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(8)


class TestDistSpMV:
    def test_dia_matches_host(self, mesh):
        H = fd_laplacian_2d(16)   # n=256, bandwidth 16
        A = shard_dia(H, mesh)
        x = np.random.default_rng(0).random(256)
        xd = pad_vector_dia(A, x)
        y = jax.jit(dist_dia_spmv)(A, xd)
        np.testing.assert_allclose(np.asarray(y)[:256], H.matvec(x),
                                   rtol=1e-12)

    def test_dia_small_n_uneven(self, mesh):
        H = fd_laplacian_1d(100)  # n=100 over 8 shards → padding
        A = shard_dia(H, mesh)
        x = np.random.default_rng(1).random(100)
        xd = pad_vector_dia(A, x)
        y = jax.jit(dist_dia_spmv)(A, xd)
        np.testing.assert_allclose(np.asarray(y)[:100], H.matvec(x),
                                   rtol=1e-12)

    def test_ell_matches_host(self, mesh):
        H, x_exact, b = dh_test_problem(8)
        n = H.shape[0]
        A = shard_ell(H, mesh)
        x = np.random.default_rng(2).random(n)
        xd = pad_vector_ell(A, x)
        y = jax.jit(dist_ell_spmv)(A, xd)
        np.testing.assert_allclose(np.asarray(y)[:n], H.matvec(x),
                                   rtol=1e-12)


class TestDistSolve:
    def test_distributed_cg_dia(self, mesh):
        H = fd_laplacian_2d(16)
        n = 256
        A = shard_dia(H, mesh)
        rng = np.random.default_rng(3)
        x_exact = rng.random(n)
        b = pad_vector_dia(A, H.matvec(x_exact))

        @jax.jit
        def solve(A, b):
            return cg_solve(lambda v: dist_dia_spmv(A, v), b,
                            maxiter=600, tau=1e-10)

        x, st, _ = solve(A, b)
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x)[:n], x_exact, atol=1e-6)

    def test_distributed_cg_ell_dh(self, mesh):
        H, x_exact, b_host = dh_test_problem(9)
        n = H.shape[0]
        A = shard_ell(H, mesh)
        b = pad_vector_ell(A, b_host)

        @jax.jit
        def solve(A, b):
            return cg_solve(lambda v: dist_ell_spmv(A, v), b,
                            maxiter=800, tau=1e-10)

        x, st, _ = solve(A, b)
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x)[:n], x_exact, atol=1e-6)

    def test_sharding_preserved(self, mesh):
        """solution comes back row-sharded (no silent full replication)."""
        H = fd_laplacian_1d(128)
        A = shard_dia(H, mesh)
        b = pad_vector_dia(A, H.matvec(np.ones(128)))

        @jax.jit
        def solve(A, b):
            x, st, _ = cg_solve(lambda v: dist_dia_spmv(A, v), b,
                                maxiter=300, tau=1e-10)
            return x

        x = solve(A, b)
        assert not x.sharding.is_fully_replicated


class TestDistGMRES:
    def test_distributed_gmres_ell(self, mesh):
        from pysolvers_tpu.linear import gmres_solve
        H, x_exact, b_host = dh_test_problem(8)
        n = H.shape[0]
        A = shard_ell(H, mesh)
        b = pad_vector_ell(A, b_host)

        @jax.jit
        def solve(A, b):
            return gmres_solve(lambda v: dist_ell_spmv(A, v), b,
                               maxiter=150, tau=1e-10, orthog="cgs2")

        x, st, _ = solve(A, b)
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x)[:n], x_exact, atol=1e-6)


class TestDistAMG:
    def test_vcycle_with_sharded_fine_level(self, mesh):
        """AMG V-cycle under GSPMD with the fine level row-sharded and
        coarse levels replicated (the standard gather-coarse policy):
        correctness is preserved and the cycle compiles+runs multi-device."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        from pysolvers_tpu.linear.amg import (build_sa_hierarchy,
                                              build_device_hierarchy,
                                              v_cycle)
        from pysolvers_tpu.sparse import DiaMatrix
        import dataclasses

        H = fd_laplacian_2d(16)          # n=256 = 8*32 rows
        n = H.shape[0]
        rng = np.random.default_rng(0)
        x_exact = rng.random(n)
        b_host = H.matvec(x_exact)

        mlh = build_sa_hierarchy(H, num_levels=2)
        h = build_device_hierarchy(mlh, "jacobi", 2, 2)

        # reference (single-device) result
        b = jnp.asarray(b_host)
        x_ref = jnp.zeros_like(b)
        for _ in range(3):
            x_ref = v_cycle(h, b, x_ref)

        # shard the fine level's matrix rows + vectors
        fine = h.levels[-1]
        diag_sh = NamedSharding(mesh, P(None, "rows"))
        row1d = NamedSharding(mesh, P("rows"))
        A_f = fine.A_dev
        assert isinstance(A_f, DiaMatrix)
        A_sh = DiaMatrix(jax.device_put(A_f.diags, diag_sh),
                         A_f.offsets, A_f.shape)
        fine_sh = dataclasses.replace(
            fine, A_dev=A_sh, dinv=jax.device_put(fine.dinv, row1d))
        h_sh = dataclasses.replace(h, levels=h.levels[:-1] + [fine_sh])

        b_sh = jax.device_put(b, row1d)

        @jax.jit
        def cycle3(b):
            x = jnp.zeros_like(b)
            for _ in range(3):
                x = v_cycle(h_sh, b, x)
            return x

        x_sh = cycle3(b_sh)
        np.testing.assert_allclose(np.asarray(x_sh), np.asarray(x_ref),
                                   rtol=1e-10, atol=1e-12)


class TestDistPreconditioned:
    def test_distributed_cg_chebyshev(self, mesh):
        """Matrix-free Chebyshev preconditioning composes with the
        distributed SpMV unchanged — the whole preconditioned solve runs
        sharded under one jit."""
        H = fd_laplacian_2d(16)
        n = 256
        A = shard_dia(H, mesh)
        rng = np.random.default_rng(7)
        x_exact = rng.random(n)
        b = pad_vector_dia(A, H.matvec(x_exact))

        # Chebyshev coefficients from the host matrix; apply is pure jnp
        from pysolvers_tpu.linear.preconditioner import (
            ChebyshevPreconditionerType)
        cheb = ChebyshevPreconditionerType(degree=4)
        lmax = cheb.estimate_lmax(H)
        lmin = lmax / cheb.eig_ratio
        theta, delta = 0.5 * (lmax + lmin), 0.5 * (lmax - lmin)
        d = H.diagonal()
        dinv_host = np.zeros(A.n_pad)
        dinv_host[:n] = 1.0 / np.where(d == 0, 1.0, d)
        dinv = pad_vector_dia(A, dinv_host[:n])

        mv = lambda v: dist_dia_spmv(A, v)

        def prec(r):
            z = jnp.zeros_like(r)
            p = dinv * r / theta
            z = z + p
            rho = delta / theta
            for _ in range(3):
                res = dinv * (r - mv(z))
                rho_new = 1.0 / (2.0 * theta / delta - rho)
                p = rho_new * rho * p + (2.0 * rho_new / delta) * res
                z = z + p
                rho = rho_new
            return z

        @jax.jit
        def solve(A, b, dinv):
            return cg_solve(mv, b, maxiter=400, tau=1e-10, precond=prec)

        x, st, _ = solve(A, b, dinv)
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x)[:n], x_exact, atol=1e-6)


class TestBlockJacobiILU:
    def test_dist_cg_with_block_ilu(self, mesh):
        from pysolvers_tpu.parallel.precond import (build_block_jacobi_ilu,
                                                    block_jacobi_apply)
        H, x_exact, b_host = dh_test_problem(10)
        n = H.shape[0]
        A = shard_ell(H, mesh)
        b = pad_vector_ell(A, b_host)
        M = build_block_jacobi_ilu(H, mesh, A.n_pad, drop_tol=1e-4,
                                   sweeps=10)

        mv = lambda v: dist_ell_spmv(A, v)

        @jax.jit
        def solve_plain(A, b):
            return cg_solve(mv, b, maxiter=800, tau=1e-10)

        @jax.jit
        def solve_prec(A, b, M):
            return cg_solve(mv, b, maxiter=800, tau=1e-10,
                            precond=lambda r: block_jacobi_apply(M, r))

        _, st0, _ = solve_plain(A, b)
        x, st1, _ = solve_prec(A, b, M)
        assert int(st1.reason) == StopReason.CONVERGED
        assert int(st1.k) < int(st0.k)
        np.testing.assert_allclose(np.asarray(x)[:n], x_exact, atol=1e-6)

    def test_preconditioner_type_factory(self, mesh):
        """BlockJacobiILUPreconditionerType.form plugs into the solver
        stack like the single-chip factories (n_pad from A_dev)."""
        from pysolvers_tpu.parallel import BlockJacobiILUPreconditionerType
        from pysolvers_tpu.linear.krylov import gmres_solve
        H, x_exact, b_host = dh_test_problem(10)
        n = H.shape[0]
        A = shard_ell(H, mesh)
        b = pad_vector_ell(A, b_host)
        M = BlockJacobiILUPreconditionerType(mesh, drop_tol=1e-4,
                                             sweeps=10).form(H, A)

        @jax.jit
        def solve(A, b):
            return gmres_solve(lambda v: dist_ell_spmv(A, v), b,
                               maxiter=400, restart=60, tau=1e-10,
                               precond=M.apply_right)

        x, st, _ = solve(A, b)
        assert int(st.reason) == StopReason.CONVERGED
        np.testing.assert_allclose(np.asarray(x)[:n], x_exact, atol=1e-6)


class TestDistAMGHelper:
    def test_build_device_hierarchy_mesh(self, mesh):
        """mesh= in build_device_hierarchy shards the fine level; cycle
        results match the replicated hierarchy exactly."""
        from pysolvers_tpu.linear.amg import (build_sa_hierarchy,
                                              build_device_hierarchy,
                                              v_cycle)
        H = fd_laplacian_2d(16)
        rng = np.random.default_rng(11)
        b = jnp.asarray(H.matvec(rng.random(256)))
        mlh = build_sa_hierarchy(H, num_levels=2)
        h_ref = build_device_hierarchy(mlh, "jacobi", 2, 2)
        h_sh = build_device_hierarchy(mlh, "jacobi", 2, 2, mesh=mesh)
        assert not h_sh.levels[-1].dinv.sharding.is_fully_replicated

        def make_cyc(h):
            @jax.jit
            def cyc(b):
                x = jnp.zeros_like(b)
                for _ in range(3):
                    x = v_cycle(h, b, x)
                return x
            return cyc

        x_ref = make_cyc(h_ref)(b)
        x_sh = make_cyc(h_sh)(jax.device_put(
            b, jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec("rows"))))
        np.testing.assert_allclose(np.asarray(x_sh), np.asarray(x_ref),
                                   rtol=1e-12, atol=1e-12)

    def test_amg_vcycle_solver_with_mesh(self, mesh):
        from pysolvers_tpu.linear.amg import AMGVCycle
        from pysolvers_tpu.core import SolverConfig
        H = fd_laplacian_2d(16)
        rng = np.random.default_rng(12)
        x_exact = rng.random(256)
        b = H.matvec(x_exact)
        solver = AMGVCycle(SolverConfig(maxiter=60, tau=1e-10),
                           num_levels=2, smoother="jacobi",
                           mesh=mesh).make_solver()
        st = solver.solve(H, b)
        assert st.success
        np.testing.assert_allclose(np.asarray(st.soln), x_exact, atol=1e-6)


class TestMeshOddSizes:
    """mesh= hierarchy path on problem sizes NOT divisible by the mesh
    (DH/GMG sizes are odd): the fine level is identity-padded at setup."""

    def test_amg_vcycle_mesh_on_dh(self, mesh):
        from pysolvers_tpu.linear.amg import AMGVCycle
        from pysolvers_tpu.core import SolverConfig
        import pysolvers_tpu as pst
        H, x_exact, b = pst.problems.dh_test_problem(8)
        assert H.shape[0] % 8 != 0      # the interesting case
        solver = AMGVCycle(SolverConfig(maxiter=80, tau=1e-10),
                           num_levels=2, smoother="jacobi",
                           mesh=mesh).make_solver()
        st = solver.solve(H, b)
        assert st.success
        assert st.soln.shape[0] == H.shape[0]
        np.testing.assert_allclose(np.asarray(st.soln), x_exact, atol=1e-6)


class TestDistGMG:
    """Distributed geometric multigrid: GMGVCycle(mesh=...) shards the
    finest level over the mesh (gather-coarse policy shared with AMG)."""

    def test_gmg_vcycle_solver_with_mesh(self, mesh):
        from pysolvers_tpu.linear.gmg import GMGVCycle
        from pysolvers_tpu.core import SolverConfig
        m = 31
        H = fd_laplacian_2d(m)
        rng = np.random.default_rng(13)
        x_exact = rng.random(m * m)
        b = H.matvec(x_exact)
        solver = GMGVCycle(SolverConfig(maxiter=60, tau=1e-10),
                           dims=(m, m), num_levels=3, smoother="jacobi",
                           nu_pre=2, nu_post=2, mesh=mesh).make_solver()
        st = solver.solve(H, b)
        assert st.success
        h = solver._hierarchy
        assert not h.levels[-1].dinv.sharding.is_fully_replicated
        np.testing.assert_allclose(np.asarray(st.soln), x_exact, atol=1e-6)


class TestEllHalo:
    """Neighbor-halo ELL path (no all-gather — scales past one chip's
    HBM for the vector; VERDICT r1 missing item 7)."""

    def test_matches_host_banded(self, mesh):
        H = fd_laplacian_2d(16)
        from pysolvers_tpu.parallel import (shard_ell_halo,
                                            dist_ell_halo_spmv,
                                            pad_vector_ell_halo)
        A = shard_ell_halo(H, mesh)
        x = np.random.default_rng(0).random(H.shape[0])
        xd = pad_vector_ell_halo(A, x)
        y = jax.jit(dist_ell_halo_spmv)(A, xd)
        np.testing.assert_allclose(np.asarray(y)[: H.shape[0]],
                                   H.matvec(x), rtol=1e-12)

    def test_matches_host_dh_rcm(self, mesh):
        from pysolvers_tpu.sparse.host import HostCSR
        from pysolvers_tpu.parallel import (shard_ell_halo,
                                            dist_ell_halo_spmv,
                                            pad_vector_ell_halo)
        H, x_exact, b = dh_test_problem(10)
        perm = H.rcm_perm()
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(len(perm))
        rows, cols, vals = H.to_coo()
        Hp = HostCSR.from_coo(iperm[rows], iperm[cols], vals, H.shape)
        A = shard_ell_halo(Hp, mesh)
        x = np.random.default_rng(1).random(H.shape[0])
        xd = pad_vector_ell_halo(A, x)
        y = jax.jit(dist_ell_halo_spmv)(A, xd)
        np.testing.assert_allclose(np.asarray(y)[: H.shape[0]],
                                   Hp.matvec(x), rtol=1e-12, atol=1e-12)

    def test_distributed_cg_halo(self, mesh):
        from pysolvers_tpu.sparse.host import HostCSR
        from pysolvers_tpu.parallel import (shard_ell_halo,
                                            dist_ell_halo_spmv,
                                            pad_vector_ell_halo)
        H, x_exact, b = dh_test_problem(10)
        perm = H.rcm_perm()
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(len(perm))
        rows, cols, vals = H.to_coo()
        Hp = HostCSR.from_coo(iperm[rows], iperm[cols], vals, H.shape)
        A = shard_ell_halo(Hp, mesh)
        bd = pad_vector_ell_halo(A, b[perm])
        x, st, _ = jax.jit(
            lambda Aa, bv: cg_solve(lambda v: dist_ell_halo_spmv(Aa, v),
                                    bv, maxiter=2000, tau=1e-10))(A, bd)
        assert int(st.reason) == StopReason.CONVERGED
        xu = np.asarray(x)[: H.shape[0]][iperm]
        np.testing.assert_allclose(xu, x_exact, atol=1e-7)

    def test_unbanded_rejected(self, mesh):
        from pysolvers_tpu.sparse.host import HostCSR
        from pysolvers_tpu.parallel import shard_ell_halo
        n = 256
        rows = np.concatenate([np.arange(n), [0]])
        cols = np.concatenate([np.arange(n), [n - 1]])
        vals = np.concatenate([np.full(n, 2.0), [1.0]])
        T = HostCSR.from_coo(rows, cols, vals, (n, n))
        import pytest as _pt
        with _pt.raises(ValueError, match="bandwidth"):
            shard_ell_halo(T, mesh)
