"""BdiaMatrix as a first-class solver citizen (VERDICT r3 item 2):
block preconditioners, mixed precision, multi-RHS, mesh= sharding.

Reference bar: every operator is preconditionable through the same
factory surface (reference PCGSolver.py:92-94, PreconditionerType.py:4-11).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pysolvers_tpu as pst
from pysolvers_tpu.sparse.bdia import BdiaMatrix
from pysolvers_tpu.problems import fd_vector_laplacian_2d


def _prob(m=16, b=2, seed=0):
    A = fd_vector_laplacian_2d(m, b=b, coupling=0.3)
    rng = np.random.default_rng(seed)
    x = rng.random(A.shape[0])
    return A, x, A.matvec(x)


class TestBlockJacobi:
    def test_batched_inverse(self):
        from pysolvers_tpu.linear.block_precond import batched_inverse
        rng = np.random.default_rng(3)
        Bs = rng.normal(size=(7, 4, 4))
        Bs = Bs @ Bs.transpose(0, 2, 1) + 4 * np.eye(4)   # SPD batch
        inv = np.asarray(batched_inverse(jnp.asarray(Bs)))
        np.testing.assert_allclose(inv, np.linalg.inv(Bs), rtol=1e-10,
                                   atol=1e-10)

    def test_diag_blocks_oracle(self):
        A, _, _ = _prob(m=6, b=3)
        Ad = BdiaMatrix.from_host_csr(A, b=3)
        D = np.asarray(Ad.diag_blocks())
        Adense = A.to_dense()
        for i in range(Ad.nb):
            np.testing.assert_allclose(
                D[i], Adense[i * 3:(i + 1) * 3, i * 3:(i + 1) * 3])

    def test_diagonal_planar(self):
        A, _, _ = _prob(m=6, b=3)
        Ad = BdiaMatrix.from_host_csr(A, b=3)
        d_planar = np.asarray(Ad.diagonal_planar())
        d_nat = A.diagonal()
        np.testing.assert_allclose(
            np.asarray(Ad.from_planar(jnp.asarray(d_planar))), d_nat)

    def test_block_jacobi_apply_oracle(self):
        from pysolvers_tpu.linear.block_precond import (
            BlockJacobiBdiaPreconditionerType)
        A, x, _ = _prob(m=6, b=3)
        Ad = BdiaMatrix.from_host_csr(A, b=3)
        prec = BlockJacobiBdiaPreconditionerType().form(A_dev=Ad)
        v = jnp.asarray(x)
        y = np.asarray(Ad.from_planar(prec.apply_any(Ad.to_planar(v))))
        # oracle: block-diagonal solve in node-major order
        Adense = A.to_dense()
        y_ref = np.concatenate([
            np.linalg.solve(Adense[i * 3:(i + 1) * 3, i * 3:(i + 1) * 3],
                            x[i * 3:(i + 1) * 3]) for i in range(Ad.nb)])
        np.testing.assert_allclose(y, y_ref, rtol=1e-5, atol=1e-6)

    def test_preconditioned_solve_converges_faster(self):
        A, x_exact, b = _prob(m=20, b=2)
        Ad = BdiaMatrix.from_host_csr(A, b=2)
        st_pre = pst.solve(Ad, b, tau=1e-10, maxiter=4000,
                           precond="bjacobi")
        st_none = pst.solve(Ad, b, tau=1e-10, maxiter=4000, precond="none")
        assert st_pre.success and st_none.success
        assert st_pre.iters <= st_none.iters
        assert np.abs(np.asarray(st_pre.soln) - x_exact).max() < 1e-6

    def test_bcheb_solve(self):
        A, x_exact, b = _prob(m=12, b=2)
        Ad = BdiaMatrix.from_host_csr(A, b=2)
        st = pst.solve(Ad, b, tau=1e-10, maxiter=2000, precond="bcheb")
        assert st.success
        assert np.abs(np.asarray(st.soln) - x_exact).max() < 1e-6

    def test_ic_solve(self):
        A, x_exact, b = _prob(m=12, b=2)
        Ad = BdiaMatrix.from_host_csr(A, b=2, dtype=np.float32)
        st = pst.solve(Ad, b, tau=1e-6, maxiter=2000, precond="ic")
        assert st.success
        assert np.abs(np.asarray(st.soln) - x_exact).max() < 1e-3


class TestBdiaMixed:
    def test_mixed_reaches_1e10(self):
        A, x_exact, b = _prob(m=20, b=2)
        Ad = BdiaMatrix.from_host_csr(A, b=2)   # f64: the mixed route
        # casts its f32 working copy internally; an f32 container would
        # cap the residual at eps32 vs the caller's operator
        st = pst.solve(Ad, b, tau=1e-10, maxiter=4000, precision="mixed",
                       precond="bjacobi")
        assert st.success
        r = b - A.matvec(np.asarray(st.soln, dtype=np.float64))
        assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(b) * 1.01
        assert np.abs(np.asarray(st.soln) - x_exact).max() < 1e-8

    def test_mixed_unpreconditioned(self):
        A, x_exact, b = _prob(m=12, b=2)
        Ad = BdiaMatrix.from_host_csr(A, b=2)
        st = pst.solve(Ad, b, tau=1e-10, maxiter=4000, precision="mixed",
                       precond="none")
        assert st.success
        r = b - A.matvec(np.asarray(st.soln, dtype=np.float64))
        assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(b) * 1.01

    def test_mixed_multi_rhs(self):
        A, _, _ = _prob(m=10, b=2)
        rng = np.random.default_rng(5)
        X = rng.random((A.shape[0], 3))
        B = np.stack([A.matvec(X[:, j]) for j in range(3)], axis=1)
        Ad = BdiaMatrix.from_host_csr(A, b=2)
        st = pst.solve(Ad, B, tau=1e-10, maxiter=4000, precision="mixed",
                       precond="bjacobi")
        assert st.success
        assert np.abs(np.asarray(st.soln) - X).max() < 1e-7


class TestBdiaMultiRhs:
    def test_lockstep_multi_rhs(self):
        A, _, _ = _prob(m=16, b=2)
        rng = np.random.default_rng(4)
        X = rng.random((A.shape[0], 4))
        B = np.stack([A.matvec(X[:, j]) for j in range(4)], axis=1)
        Ad = BdiaMatrix.from_host_csr(A, b=2)
        st = pst.solve(Ad, B, tau=1e-11, maxiter=4000, precond="bjacobi")
        assert st.success
        assert st.soln.shape == (A.shape[0], 4)
        assert np.abs(np.asarray(st.soln) - X).max() < 1e-7

    def test_multi_matches_single(self):
        A, _, _ = _prob(m=10, b=2)
        rng = np.random.default_rng(6)
        X = rng.random((A.shape[0], 2))
        B = np.stack([A.matvec(X[:, j]) for j in range(2)], axis=1)
        Ad = BdiaMatrix.from_host_csr(A, b=2)
        st_m = pst.solve(Ad, B, tau=1e-11, maxiter=4000, precond="bjacobi")
        st_0 = pst.solve(Ad, B[:, 0], tau=1e-11, maxiter=4000,
                         precond="bjacobi")
        np.testing.assert_allclose(np.asarray(st_m.soln[:, 0]),
                                   np.asarray(st_0.soln), rtol=1e-6,
                                   atol=1e-9)


class TestBdiaMesh:
    def _mesh(self, n=8):
        from pysolvers_tpu.parallel.mesh import make_mesh
        return make_mesh(n)

    def test_dist_spmv_oracle(self):
        from pysolvers_tpu.parallel.bdia import shard_bdia, dist_bdia_spmv
        A, x, _ = _prob(m=16, b=2)
        Ad = BdiaMatrix.from_host_csr(A, b=2)
        S = shard_bdia(Ad, self._mesh())
        xb = S.to_planar(x)
        y = np.asarray(S.from_planar(dist_bdia_spmv(S, xb)))
        np.testing.assert_allclose(y, A.matvec(x), rtol=1e-10, atol=1e-10)

    def test_mesh_solve_native(self):
        A, x_exact, b = _prob(m=16, b=2)
        Ad = BdiaMatrix.from_host_csr(A, b=2)
        st = pst.solve(Ad, b, tau=1e-11, maxiter=4000, precond="bjacobi",
                       mesh=self._mesh())
        assert st.success
        assert np.abs(np.asarray(st.soln) - x_exact).max() < 1e-7

    def test_mesh_solve_mixed(self):
        A, x_exact, b = _prob(m=16, b=2)
        Ad = BdiaMatrix.from_host_csr(A, b=2)
        st = pst.solve(Ad, b, tau=1e-10, maxiter=4000, precond="bjacobi",
                       precision="mixed", mesh=self._mesh())
        assert st.success
        r = b - A.matvec(np.asarray(st.soln, dtype=np.float64))
        assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(b) * 1.01

    def test_block_jacobi_sharded_matches_single(self):
        from pysolvers_tpu.parallel.bdia import (block_jacobi_sharded,
                                                 shard_bdia)
        from pysolvers_tpu.linear.block_precond import (
            BlockJacobiBdiaPreconditionerType)
        A, x, _ = _prob(m=16, b=2)
        Ad = BdiaMatrix.from_host_csr(A, b=2)
        S = shard_bdia(Ad, self._mesh())
        apply, state = block_jacobi_sharded(S)
        y_dist = np.asarray(S.from_planar(apply(state, S.to_planar(x))))
        prec = BlockJacobiBdiaPreconditionerType().form(A_dev=Ad)
        y_one = np.asarray(Ad.from_planar(
            prec.apply_any(Ad.to_planar(jnp.asarray(x)))))
        np.testing.assert_allclose(y_dist, y_one, rtol=1e-6, atol=1e-8)
