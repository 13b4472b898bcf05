"""Block-DIA (BSR-class) container + kernels (VERDICT r2 item 8).

Oracle tests vs host CSR, round-trips, SpMM, CG on the vector-Laplacian
multi-dof problem, and the profitability gate.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import pysolvers_tpu as pst
from pysolvers_tpu.sparse.bdia import BdiaMatrix
from pysolvers_tpu.ops.spmv import bdia_spmv, bdia_spmm
from pysolvers_tpu.ops import matvec, matmat
from pysolvers_tpu.problems import fd_vector_laplacian_2d


def _prob(m=12, b=3):
    A = fd_vector_laplacian_2d(m, b=b, coupling=0.3)
    rng = np.random.default_rng(0)
    x = rng.random(A.shape[0])
    return A, x


class TestBdia:
    @pytest.mark.parametrize("b", [1, 2, 3, 4])
    def test_spmv_oracle(self, b):
        # vectors are PLANAR-ordered at the kernel boundary (module doc)
        A, x = _prob(b=b)
        Ad = BdiaMatrix.from_host_csr(A, b=b)
        xp = Ad.to_planar(jnp.asarray(x))
        y = np.asarray(Ad.from_planar(bdia_spmv(Ad, xp)))
        np.testing.assert_allclose(y, A.matvec(x), rtol=1e-12, atol=1e-12)

    def test_planar_round_trip(self):
        A, x = _prob(b=3)
        Ad = BdiaMatrix.from_host_csr(A, b=3)
        xp = Ad.to_planar(jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(Ad.from_planar(xp)), x)

    def test_matvec_dispatch(self):
        A, x = _prob()
        Ad = BdiaMatrix.from_host_csr(A, b=3)
        y = np.asarray(Ad.from_planar(
            matvec(Ad, Ad.to_planar(jnp.asarray(x)))))
        np.testing.assert_allclose(y, A.matvec(x), rtol=1e-12, atol=1e-12)

    def test_spmm_oracle_and_dispatch(self):
        A, _ = _prob()
        rng = np.random.default_rng(1)
        X = rng.random((A.shape[0], 5))
        Ad = BdiaMatrix.from_host_csr(A, b=3)
        Xp = Ad.to_planar(jnp.asarray(X))
        Y = np.asarray(Ad.from_planar(bdia_spmm(Ad, Xp)))
        Yref = np.stack([A.matvec(X[:, j]) for j in range(5)], axis=1)
        np.testing.assert_allclose(Y, Yref, rtol=1e-12, atol=1e-12)
        Y2 = np.asarray(Ad.from_planar(matmat(Ad, Xp)))
        np.testing.assert_allclose(Y2, Yref, rtol=1e-12, atol=1e-12)

    def test_round_trip(self):
        A, _ = _prob(m=6, b=2)
        Ad = BdiaMatrix.from_host_csr(A, b=2)
        B = Ad.to_host_csr()
        np.testing.assert_allclose(B.to_dense(), A.to_dense(),
                                   rtol=0, atol=1e-15)

    def test_cg_on_vector_laplacian(self):
        A, x_exact = _prob(m=16, b=2)
        b_rhs = A.matvec(x_exact)
        Ad = BdiaMatrix.from_host_csr(A, b=2)
        bp = Ad.to_planar(jnp.asarray(b_rhs))
        x, st, _ = pst.cg_solve(lambda v: matvec(Ad, v), bp,
                                maxiter=2000, tau=1e-11)
        assert int(st.reason) == 1
        xu = np.asarray(Ad.from_planar(x))
        assert np.abs(xu - x_exact).max() < 1e-7

    def test_profitability_gate(self):
        A, _ = _prob(m=10, b=2)
        assert BdiaMatrix.is_profitable(A, 2)
        # unstructured random matrix: too many block offsets
        rng = np.random.default_rng(2)
        n = 64
        r = rng.integers(0, n, 600)
        c = rng.integers(0, n, 600)
        R = pst.HostCSR.from_coo(np.concatenate([r, np.arange(n)]),
                                 np.concatenate([c, np.arange(n)]),
                                 np.ones(600 + n), (n, n))
        assert not BdiaMatrix.is_profitable(R, 2)

    def test_bad_block_size_raises(self):
        A, _ = _prob(m=5, b=3)      # n = 75
        with pytest.raises(ValueError):
            BdiaMatrix.from_host_csr(A, b=2)

    def test_spd_guard(self):
        with pytest.raises(ValueError):
            fd_vector_laplacian_2d(4, b=3, coupling=0.6)

    def test_solve_front_end_accepts_bdia(self):
        A, x_exact = _prob(m=16, b=2)
        b_rhs = A.matvec(x_exact)
        Ad = BdiaMatrix.from_host_csr(A, b=2)
        st = pst.solve(Ad, b_rhs, tau=1e-11, maxiter=3000)
        assert st.success
        assert np.abs(np.asarray(st.soln) - x_exact).max() < 1e-7

    def test_plan_cache_keys_on_row_tile(self):
        # the cached flat scatter indices embed nb_pad — a different
        # row_tile must NOT reuse them (review finding: silent corruption)
        A, x = _prob(m=12, b=2)
        A1 = BdiaMatrix.from_host_csr(A, b=2, row_tile=128)
        A2 = BdiaMatrix.from_host_csr(A, b=2, row_tile=256)
        for Ad in (A1, A2):
            xp = Ad.to_planar(jnp.asarray(x))
            y = np.asarray(Ad.from_planar(bdia_spmv(Ad, xp)))
            np.testing.assert_allclose(y, A.matvec(x), rtol=1e-12,
                                       atol=1e-12)

    def test_solve_rejects_unsupported_options(self):
        A, x = _prob(m=8, b=2)
        Ad = BdiaMatrix.from_host_csr(A, b=2)
        with pytest.raises(ValueError):
            pst.solve(Ad, A.matvec(x), precond="amg")   # not a BDIA prec
        with pytest.raises(ValueError):
            pst.solve(Ad, A.matvec(x), precision="half")
