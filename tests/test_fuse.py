"""Fused one-dispatch setup (ops/fuse.py): blob packing round trips and
multi-item builds match the separate-dispatch results."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pysolvers_tpu as pst
from pysolvers_tpu.ops.fuse import (SetupItem, blob_pack, blob_split,
                                    fused_build)
from pysolvers_tpu.sparse.host import HostCSR


def _banded(n=700, seed=0, spd=False):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 5)
    cols = (rows + rng.integers(-40, 40, len(rows))) % n
    vals = rng.standard_normal(len(rows))
    H = HostCSR.from_coo(rows, cols, vals, (n, n))
    if spd:
        Ht = H.transpose()
        H = H.add(Ht)
        d = np.abs(H.to_dense()).sum(axis=1) + 1.0
        H = H.add(HostCSR.from_coo(np.arange(n), np.arange(n), d, (n, n)))
    return H


class TestBlob:
    def test_roundtrip_all_kinds(self):
        arrays = [
            np.arange(7, dtype=np.int32).reshape(7),
            np.linspace(-2, 3, 6, dtype=np.float32).reshape(2, 3),
            np.array([1.5, -2.25, 1e-300, 3e200], dtype=np.float64),
            np.arange(9, dtype=np.uint8),
            np.array([[5, -6], [7, 8]], dtype=np.int64),
        ]
        blob, specs = blob_pack(arrays)
        assert blob.dtype == np.int32
        out = jax.jit(lambda b: tuple(blob_split(b, specs)))(
            jnp.asarray(blob))
        for a, o in zip(arrays, out):
            got = np.asarray(o)
            assert got.shape == a.shape
            np.testing.assert_array_equal(got.astype(np.float64),
                                          a.astype(np.float64))

    def test_int64_overflow_rejected(self):
        with pytest.raises(ValueError):
            blob_pack([np.array([2 ** 40], dtype=np.int64)])

    def test_fused_build_multi_item(self):
        a = np.arange(12, dtype=np.float32)
        b = np.arange(5, dtype=np.int32)

        outs = fused_build([
            SetupItem((a,), _sum_build, ()),
            SetupItem((b,), _scale_build, (3,)),
        ])
        assert float(outs[0]) == float(a.sum())
        np.testing.assert_array_equal(np.asarray(outs[1]), b * 3)


def _sum_build(arrs, st):
    return jnp.sum(arrs[0])


def _scale_build(arrs, st):
    return arrs[0] * st[0]


class TestFusedSetup:
    def test_ic_prep_fuses_with_pack(self):
        """A passthrough operator upload + IC factor-plan build in ONE
        dispatch produce the same preconditioner as the separate form()
        route."""
        from pysolvers_tpu.linear.ilu import ICPreconditionerType
        from pysolvers_tpu.ops.fuse import passthrough_build

        H = _banded(spd=True)
        Hp = H.permute_symmetric(H.rcm_perm())
        Hp32 = HostCSR(Hp.indptr, Hp.indices,
                       Hp.data.astype(np.float32), Hp.shape)

        t = ICPreconditionerType(1e-3, 15, trisolve_mode="block")
        pp = t.prep(Hp32)
        assert pp is not None
        d = Hp32.diagonal()
        outs = fused_build([SetupItem((d,), passthrough_build, ()), pp[0]])
        np.testing.assert_array_equal(np.asarray(outs[0]), d)
        prec_fused = pp[1](outs[1])

        prec_direct = ICPreconditionerType(
            1e-3, 15, trisolve_mode="block").form(Hp32)
        v = np.random.default_rng(1).standard_normal(
            H.shape[0]).astype(np.float32)
        yf = np.asarray(prec_fused.apply_right(jnp.asarray(v)))
        yd = np.asarray(prec_direct.apply_right(jnp.asarray(v)))
        np.testing.assert_allclose(yf, yd, rtol=1e-6, atol=1e-6)

    def test_ilut_prep_fuses(self):
        from pysolvers_tpu.linear.ilu import ILUTPreconditionerType

        H = _banded(seed=3)
        # diagonal boost so the factorization is stable
        n = H.shape[0]
        H = H.add(HostCSR.from_coo(np.arange(n), np.arange(n),
                                   np.full(n, 8.0), (n, n)))
        t = ILUTPreconditionerType(1e-3, 15, trisolve_mode="block")
        pp = t.prep(HostCSR(H.indptr, H.indices,
                            H.data.astype(np.float32), H.shape))
        assert pp is not None
        (out,) = fused_build([pp[0]])
        prec = pp[1](out)
        v = np.random.default_rng(2).standard_normal(n).astype(np.float32)
        y = np.asarray(prec.apply_right(jnp.asarray(v)))
        assert np.isfinite(y).all()

    def test_prep_none_for_non_block_modes(self):
        from pysolvers_tpu.linear.ilu import ICPreconditionerType

        t = ICPreconditionerType(1e-3, 15, trisolve_mode="level")
        assert t.prep(_banded(spd=True)) is None


class TestFusedMixedSolve:
    def test_mixed_factory_fused_path(self):
        """Mixed factory solve with the block-trisolve IC preconditioner
        reaches 1e-10; frozen matrix + prec reuse the formed products."""
        H = _banded(spd=True)
        x_exact = np.random.default_rng(5).standard_normal(H.shape[0])
        b = H.matvec(x_exact)
        solver = pst.PCG(pst.CommonSolverArgs(maxiter=400, tau=1e-10),
                         precond=pst.RightIC(1e-3, 15,
                                             trisolve_mode="block"),
                         precision="mixed").make_solver()
        st = solver.solve(H, b)
        assert st.success
        err = np.linalg.norm(np.asarray(st.soln) - x_exact)
        assert err < 1e-6 * np.linalg.norm(x_exact)
        solver.freeze_matrix()
        solver.freeze_prec()
        st2 = solver.solve(H, b)
        assert st2.success


class TestSymbolicPackCache:
    def test_same_structure_repack_matches_fresh(self):
        """An ELL re-pack with new values on the cached column table must
        equal a fresh pack of the same matrix (cache cleared)."""
        from pysolvers_tpu.sparse import device as dev_mod

        H1 = _banded(seed=11)
        rng = np.random.default_rng(12)
        H2 = HostCSR(H1.indptr, H1.indices,
                     rng.standard_normal(H1.nnz), H1.shape)

        dev_mod._ELL_COLS_CACHE.clear()
        A1 = pst.EllMatrix.from_host_csr(H1, dtype=np.float32)
        assert len(dev_mod._ELL_COLS_CACHE) == 1
        A2_cached = pst.EllMatrix.from_host_csr(H2, dtype=np.float32)
        assert A2_cached.cols is A1.cols          # structure reused

        dev_mod._ELL_COLS_CACHE.clear()
        A2_fresh = pst.EllMatrix.from_host_csr(H2, dtype=np.float32)

        np.testing.assert_array_equal(np.asarray(A2_cached.data),
                                      np.asarray(A2_fresh.data))
        np.testing.assert_array_equal(np.asarray(A2_cached.cols),
                                      np.asarray(A2_fresh.cols))
        # values actually differ from the first pack (not a stale hit)
        assert not np.array_equal(np.asarray(A2_cached.data),
                                  np.asarray(A1.data))

    def test_different_structure_not_aliased(self):
        from pysolvers_tpu.sparse import device as dev_mod

        dev_mod._ELL_COLS_CACHE.clear()
        H1 = _banded(seed=21)
        H3 = _banded(n=704, seed=22)
        pst.EllMatrix.from_host_csr(H1, dtype=np.float32)
        A3 = pst.EllMatrix.from_host_csr(H3, dtype=np.float32)
        assert len(dev_mod._ELL_COLS_CACHE) == 2
        assert A3.shape == (704, 704)
        y = np.asarray(pst.matvec(A3, jnp.ones(704, jnp.float32)))
        np.testing.assert_allclose(y, H3.matvec(np.ones(704)), rtol=1e-5,
                                   atol=1e-4)
