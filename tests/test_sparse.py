"""Container + kernel unit tests against scipy/numpy oracles (SURVEY §4a)."""
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from pysolvers_tpu.sparse import HostCSR, EllMatrix, DiaMatrix, read_mtx
from pysolvers_tpu.ops import matvec, ell_spmv_xla, dia_spmv_xla
from pysolvers_tpu.problems import fd_laplacian_1d, fd_laplacian_2d


def random_csr(n, m, density=0.05, seed=0, spd=False):
    rng = np.random.default_rng(seed)
    A = sp.random(n, m, density=density, random_state=rng, format="csr")
    if spd:
        A = A + A.T + n * sp.eye(n)
        A = A.tocsr()
    return A


def to_host(A: sp.csr_matrix) -> HostCSR:
    A = A.tocsr()
    A.sort_indices()
    return HostCSR(A.indptr.astype(np.int64), A.indices.astype(np.int32),
                   A.data.copy(), A.shape)


class TestHostCSR:
    def test_from_coo_roundtrip(self):
        S = random_csr(40, 30, 0.1)
        coo = S.tocoo()
        H = HostCSR.from_coo(coo.row, coo.col, coo.data, S.shape)
        np.testing.assert_allclose(H.to_dense(), S.toarray(), atol=1e-14)

    def test_duplicates_summed(self):
        H = HostCSR.from_coo([0, 0, 1], [1, 1, 0], [2.0, 3.0, 1.0], (2, 2))
        assert H.to_dense()[0, 1] == 5.0

    def test_matvec_oracle(self):
        S = random_csr(64, 64, 0.1, seed=1)
        H = to_host(S)
        x = np.random.default_rng(2).random(64)
        np.testing.assert_allclose(H.matvec(x), S @ x, rtol=1e-13)

    def test_matmat_oracle(self):
        A = random_csr(32, 48, 0.15, seed=3)
        B = random_csr(48, 24, 0.15, seed=4)
        C = to_host(A).matmat(to_host(B))
        np.testing.assert_allclose(C.to_dense(), (A @ B).toarray(), atol=1e-13)

    def test_transpose(self):
        S = random_csr(20, 35, 0.2, seed=5)
        np.testing.assert_allclose(to_host(S).transpose().to_dense(),
                                   S.T.toarray(), atol=1e-14)

    def test_diagonal_triangles(self):
        S = random_csr(30, 30, 0.2, seed=6) + sp.eye(30)
        H = to_host(S.tocsr())
        np.testing.assert_allclose(H.diagonal(), S.diagonal(), atol=1e-14)
        np.testing.assert_allclose(H.extract_lower().to_dense(),
                                   sp.tril(S).toarray(), atol=1e-14)
        np.testing.assert_allclose(H.extract_upper().to_dense(),
                                   sp.triu(S).toarray(), atol=1e-14)


class TestDeviceFormats:
    @pytest.mark.parametrize("n,m,density", [(50, 50, 0.1), (33, 65, 0.2),
                                             (128, 128, 0.02)])
    def test_ell_spmv(self, n, m, density):
        S = random_csr(n, m, density, seed=n)
        H = to_host(S)
        E = EllMatrix.from_host_csr(H)
        x = np.random.default_rng(7).random(m)
        y = ell_spmv_xla(E, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), S @ x, rtol=1e-12)

    def test_ell_roundtrip(self):
        S = random_csr(40, 40, 0.1, seed=8)
        H = to_host(S)
        E = EllMatrix.from_host_csr(H)
        np.testing.assert_allclose(E.to_host_csr().to_dense(), S.toarray(),
                                   atol=1e-14)

    def test_dia_spmv_laplacian(self):
        H = fd_laplacian_2d(9)
        D = DiaMatrix.from_host_csr(H)
        x = np.random.default_rng(9).random(81)
        y = dia_spmv_xla(D, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), H.matvec(x), rtol=1e-12)

    def test_matvec_dispatch(self):
        H = fd_laplacian_1d(77)
        x = np.random.default_rng(10).random(77)
        for M in (EllMatrix.from_host_csr(H), DiaMatrix.from_host_csr(H)):
            y = matvec(M, jnp.asarray(x))
            np.testing.assert_allclose(np.asarray(y), H.matvec(x), rtol=1e-12)


class TestProblems:
    def test_laplacian_1d_matches_reference_stencil(self):
        m = 10
        H = fd_laplacian_1d(m)
        h2 = (m + 1.0) ** 2
        D = H.to_dense()
        assert np.allclose(np.diag(D), 2 * h2)
        assert np.allclose(np.diag(D, 1), -h2)

    def test_laplacian_2d_symmetry_and_rowsum(self):
        H = fd_laplacian_2d(8)
        D = H.to_dense()
        np.testing.assert_allclose(D, D.T)
        # interior rows sum to 0, boundary-adjacent rows positive
        assert (D.sum(axis=1) >= -1e-9).all()


class TestMtxIO:
    def test_read_dh_matches_scipy(self):
        import scipy.io as sio
        path = "/root/reference/TestMatrices/DH-Matrix-5.mtx"
        H = read_mtx(path)
        S = sio.mmread(path).tocsr()
        np.testing.assert_allclose(H.to_dense(), S.toarray(), atol=1e-14)

    def test_write_read_roundtrip(self, tmp_path):
        from pysolvers_tpu.sparse import write_mtx
        S = random_csr(25, 25, 0.15, seed=11)
        H = to_host(S)
        p = str(tmp_path / "t.mtx")
        write_mtx(p, H)
        np.testing.assert_allclose(read_mtx(p).to_dense(), S.toarray(),
                                   atol=1e-14)

    def test_array_format_rejected_not_silent(self, tmp_path):
        """A dense 'array' MTX must raise (fallback path), not be parsed
        by the native fast path as an empty coordinate matrix."""
        import pytest
        p = str(tmp_path / "a.mtx")
        with open(p, "w") as f:
            f.write("%%MatrixMarket matrix array real general\n"
                    "2 2\n1.0\n2.0\n3.0\n4.0\n")
        with pytest.raises(NotImplementedError):
            read_mtx(p)

    def test_capitalized_symmetric_banner(self, tmp_path):
        """Banner keywords are case-insensitive per the MTX spec: a
        'Symmetric' banner must still expand the stored triangle."""
        p = str(tmp_path / "s.mtx")
        with open(p, "w") as f:
            f.write("%%MatrixMarket Matrix Coordinate Real Symmetric\n"
                    "2 2 3\n1 1 2.0\n2 1 -1.0\n2 2 2.0\n")
        H = read_mtx(p)
        np.testing.assert_allclose(H.to_dense(),
                                   [[2.0, -1.0], [-1.0, 2.0]])

    def test_truncated_file_fails_loudly(self, tmp_path):
        """A file whose data section is shorter than the header's nnz must
        raise, not hand the solver a partial operator."""
        import pytest
        p = str(tmp_path / "t.mtx")
        with open(p, "w") as f:
            f.write("%%MatrixMarket matrix coordinate real general\n"
                    "3 3 5\n1 1 1.0\n2 2 1.0\n")
        with pytest.raises(Exception):
            read_mtx(p)

    def test_duplicate_entries_summed(self, tmp_path):
        """scipy.mmread sums duplicate coordinates; so do we (repeated
        columns in a row would corrupt the factorizations, which assign
        per column rather than accumulate)."""
        p = str(tmp_path / "d.mtx")
        with open(p, "w") as f:
            f.write("%%MatrixMarket matrix coordinate real general\n"
                    "2 2 3\n1 1 1.5\n1 1 2.5\n2 2 1.0\n")
        H = read_mtx(p)
        np.testing.assert_allclose(H.to_dense(), [[4.0, 0.0], [0.0, 1.0]])
        assert H.nnz == 2


class TestSpMM:
    def test_ell_spmm_matches_loop(self):
        S = random_csr(48, 48, 0.12, seed=21)
        H = to_host(S)
        E = EllMatrix.from_host_csr(H)
        from pysolvers_tpu.ops.spmv import matmat
        X = np.random.default_rng(22).random((48, 5))
        Y = matmat(E, jnp.asarray(X))
        np.testing.assert_allclose(np.asarray(Y), S @ X, rtol=1e-12)

    def test_dia_spmm(self):
        H = fd_laplacian_2d(8)
        D = DiaMatrix.from_host_csr(H)
        from pysolvers_tpu.ops.spmv import matmat
        X = np.random.default_rng(23).random((64, 3))
        Y = matmat(D, jnp.asarray(X))
        ref = np.stack([H.matvec(X[:, j]) for j in range(3)], axis=1)
        np.testing.assert_allclose(np.asarray(Y), ref, rtol=1e-12)


class TestDiaRectangular:
    """Regression: dia_spmv_xla under-padded x for TALL rectangular
    operators (pad computed from n_rows, x has n_cols entries) and
    dynamic_slice clamped the out-of-bounds start — wrong values for any
    DIA-formatted GMG/AMG prolongator (caught by the 3-level GMG cycle)."""

    @pytest.mark.parametrize("shape", [(31, 15), (15, 31), (64, 16)])
    def test_dia_matvec_rectangular(self, shape):
        n, m = shape
        rng = np.random.default_rng(5)
        # banded rectangular pattern around the scaled diagonal
        rows = np.repeat(np.arange(n), 2)
        cols = np.clip(rows // max(n // m, 1) +
                       np.tile([0, 1], n), 0, m - 1)
        vals = rng.standard_normal(len(rows))
        S = sp.coo_matrix((vals, (rows, cols)), shape=shape).tocsr()
        H = to_host(S)
        D = DiaMatrix.from_host_csr(H)
        x = rng.standard_normal(m)
        y = dia_spmv_xla(D, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), S @ x, rtol=1e-12,
                                   atol=1e-12)


def test_permute_symmetric_matches_coo_route():
    import numpy as np
    from pysolvers_tpu.sparse.host import HostCSR, _PERM_CACHE

    rng = np.random.default_rng(7)
    n = 60
    rows = np.repeat(np.arange(n), 4)
    cols = (rows + rng.integers(-9, 9, len(rows))) % n
    vals = rng.standard_normal(len(rows))
    H = HostCSR.from_coo(rows, cols, vals, (n, n))
    perm = rng.permutation(n)

    iperm = np.empty(n, dtype=np.int64)
    iperm[perm] = np.arange(n)
    r, c, v = H.to_coo()
    ref = HostCSR.from_coo(iperm[r], iperm[c], v, (n, n))

    _PERM_CACHE.clear()
    got = H.permute_symmetric(perm)
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.data, ref.data)

    # cached plan: same structure, new values -> single gather, same result
    H2 = HostCSR(H.indptr, H.indices, rng.standard_normal(H.nnz), H.shape)
    got2 = H2.permute_symmetric(perm)
    ref2 = HostCSR.from_coo(iperm[r], iperm[c], H2.data, (n, n))
    assert len(_PERM_CACHE) == 1
    np.testing.assert_allclose(got2.data, ref2.data)


def test_permute_symmetric_native_plan_matches_numpy(monkeypatch):
    """The C++ csr_permute_plan (segment copy + per-row sort, threaded)
    must produce bit-identical plans to the numpy fused-argsort fallback
    — both routes are live (the fallback runs under PST_NO_NATIVE)."""
    import numpy as np
    import pysolvers_tpu.sparse.host as host_mod
    from pysolvers_tpu.sparse.host import HostCSR, _PERM_CACHE
    from pysolvers_tpu.utils import native as native_mod

    if native_mod.get_lib() is None:
        import pytest
        pytest.skip("native lib unavailable")

    rng = np.random.default_rng(11)
    n = 400
    rows = np.repeat(np.arange(n), 6)
    cols = (rows + rng.integers(-25, 25, len(rows))) % n
    vals = rng.standard_normal(len(rows))
    H = HostCSR.from_coo(rows, cols, vals, (n, n))
    perm = rng.permutation(n)

    _PERM_CACHE.clear()
    got_native = H.permute_symmetric(perm)

    _PERM_CACHE.clear()
    monkeypatch.setattr(native_mod, "csr_permute_plan",
                        lambda *a, **k: None)
    # host.py imports the function at call time from utils.native
    got_numpy = H.permute_symmetric(perm)

    np.testing.assert_array_equal(got_native.indptr, got_numpy.indptr)
    np.testing.assert_array_equal(got_native.indices, got_numpy.indices)
    np.testing.assert_array_equal(got_native.data, got_numpy.data)
    _PERM_CACHE.clear()


class TestEllTMatrix:
    def test_slot_major_matches_row_major_splitgather(self):
        """EllTMatrix (slot-major) f64 matvec == EllMatrix path == host
        f64 matvec."""
        import jax
        import jax.numpy as jnp
        from pysolvers_tpu.ops.spmv import (ell_spmv_f64,
                                            ellt_spmv_f64)
        from pysolvers_tpu.sparse.device import EllMatrix, EllTMatrix
        from pysolvers_tpu.problems import dh_test_problem

        H, _, _ = dh_test_problem(8)
        E = EllMatrix.from_host_csr(H, dtype=np.float64)
        T = EllTMatrix.from_host_csr(H, dtype=np.float64)
        assert T.k == E.k and T.shape == E.shape
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.random(H.shape[0]))
        y_e = np.asarray(jax.jit(ell_spmv_f64)(E, x))
        y_t = np.asarray(jax.jit(ellt_spmv_f64)(T, x))
        y_h = H.matvec(np.asarray(x))
        np.testing.assert_allclose(y_t, y_e, rtol=0, atol=1e-13)
        np.testing.assert_allclose(y_t, y_h, rtol=1e-13, atol=1e-12)
