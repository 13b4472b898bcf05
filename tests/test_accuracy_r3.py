"""Round-3 accuracy work: f64-grade iteration counts and solution error
at f32 kernel speed (VERDICT r2 item 1 + item 9).

Pins:
* drop-scale auto-calibration targets the fill budget (replaces the
  round-2 DROP_CALIBRATION=0.1 fudge) and caches the resolved scale;
* cg_solve_rr(hi_matvec=True): f64 recurrence matvec + f32
  preconditioner reaches f64-CG iteration counts and declares
  convergence only on replaced (true) residuals;
* ir_solve_dd's f64 FGMRES path (hi_matvec) and the `overshoot` knob
  that bounds the solution error.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import pysolvers_tpu as pst
from pysolvers_tpu.ops.fuse import fused_build
from pysolvers_tpu.linear.ilu import (ICPreconditionerType,
                                      ILUTPreconditionerType,
                                      _SCALE_CACHE, _AUTO_BUDGET_FRAC)
from pysolvers_tpu.linear.krylov import cg_solve_rr
from pysolvers_tpu.linear.refine import ir_solve_dd
from pysolvers_tpu.sparse.host import HostCSR


def _dh(lev=10):
    H, x_exact, b = pst.problems.dh_test_problem(lev)
    perm = H.rcm_perm()
    Hp = H.permute_symmetric(perm)
    Hp32 = HostCSR(Hp.indptr, Hp.indices, Hp.data.astype(np.float32),
                   Hp.shape)
    A32 = pst.EllMatrix.from_host_csr(Hp32, dtype=np.float32)
    return H, x_exact, b, A32, perm, Hp, Hp32


class TestAutoDropScale:
    def test_auto_strengthens_vs_seed(self):
        # the budget search runs only on the block-trisolve path, where
        # retained fill is bandwidth-free (fill_is_free)
        _, _, _, _, _, _, Hp32 = _dh(10)
        auto = ICPreconditionerType(
            1e-3, 15.0, trisolve_mode="block")._factor(Hp32)
        seed = ICPreconditionerType(1e-3, 15.0, drop_scale=0.1)._factor(Hp32)
        assert auto.nnz > seed.nnz
        # within the budget guard
        assert 2 * auto.nnz <= 2.0 * 15.0 * Hp32.nnz + 2 * Hp32.shape[0]

    def test_resolved_scale_is_cached(self):
        _, _, _, _, _, _, Hp32 = _dh(10)
        _SCALE_CACHE.clear()
        pt = ICPreconditionerType(1e-3, 15.0, trisolve_mode="block")
        pt._factor(Hp32)
        key = ("ic", 1e-3, 15.0, Hp32.shape, Hp32.nnz)
        assert key in _SCALE_CACHE
        s = _SCALE_CACHE[key]
        # warm call resolves to the same scale without re-searching
        pt._factor(Hp32)
        assert _SCALE_CACHE[key] == s

    def test_level_mode_skips_the_budget_search(self):
        # level/sweep applies scale with nnz — auto keeps the seed scale
        # there (measured: the fuller factor made CPU solves 1.5x slower)
        _, _, _, _, _, _, Hp32 = _dh(10)
        lvl = ICPreconditionerType(
            1e-3, 15.0, trisolve_mode="level")._factor(Hp32)
        seed = ICPreconditionerType(
            1e-3, 15.0, drop_scale=0.1,
            trisolve_mode="level")._factor(Hp32)
        assert lvl.nnz == seed.nnz

    def test_float_scale_respected(self):
        _, _, _, _, _, _, Hp32 = _dh(10)
        a = ILUTPreconditionerType(1e-3, 15.0, drop_scale=1.0)._factor(Hp32)
        c = ILUTPreconditionerType(1e-3, 15.0, drop_scale=0.01)._factor(Hp32)
        assert c[0].nnz + c[1].nnz > a[0].nnz + a[1].nnz

    def test_budget_frac_reached_on_dh(self):
        _, _, _, _, _, _, Hp32 = _dh(13)
        L, U = ILUTPreconditionerType(
            1e-3, 15.0, trisolve_mode="block")._factor(Hp32)
        total = L.nnz + U.nnz
        target = _AUTO_BUDGET_FRAC * 15.0 * Hp32.nnz
        assert total >= 0.5 * target   # the one-shot jump lands near it


def _ic_state(Hp32):
    pt = ICPreconditionerType(1e-3, 15, trisolve_mode="block")
    pp = pt.prep(Hp32)
    (out,) = fused_build([pp[0]])
    return pp[1](out)


class TestHiMatvecRR:
    def test_f64_grade_iterations_and_true_convergence(self):
        H, x_exact, b, A32, perm, Hp, Hp32 = _dh(11)
        M = _ic_state(Hp32)
        A64 = pst.EllMatrix.from_host_csr(Hp, dtype=np.float64)
        from pysolvers_tpu.ops.spmv import ell_spmv_f64
        from pysolvers_tpu.ops import matvec as op_matvec
        bp = b[perm].astype(np.float64)
        bn = np.linalg.norm(bp)
        apply_fn, state = M.traced
        x, st, _ = cg_solve_rr(
            lambda v: op_matvec(A32, v), jnp.asarray(bp / bn),
            mv_hi=lambda v: ell_spmv_f64(A64, v),
            maxiter=200, tau=1e-10,
            precond=lambda v: apply_fn(state, v), hi_matvec=True)
        assert int(st.reason) == 1
        # f64-CG-grade count (f32 recurrence needed ~1.4x this)
        assert int(st.k) <= 15
        # convergence was declared on a replaced residual -> true resid
        r = bp / bn - np.asarray(Hp.matvec(np.asarray(x)))
        assert np.linalg.norm(r) <= 1.2e-10

    def test_dd_chain_overshoot_bounds_error(self):
        H, x_exact, b, A32, perm, Hp, Hp32 = _dh(11)
        M = _ic_state(Hp32)
        A64 = pst.EllMatrix.from_host_csr(Hp, dtype=np.float64)
        bp = b[perm].astype(np.float64)
        iperm = np.empty(len(perm), dtype=np.int64)
        iperm[perm] = np.arange(len(perm))
        x, st, _ = ir_solve_dd(Hp.matvec, bp, A_lo=A32, A64=A64,
                               tau=1e-10, inner_maxiter=200, method="cg",
                               precond_pair=M.traced, overshoot=0.005)
        assert int(st.reason) == 1
        rel = (np.linalg.norm(bp - Hp.matvec(np.asarray(x)))
               / np.linalg.norm(bp))
        assert rel <= 1e-11          # overshoot drove past the user tau
        err = np.linalg.norm(np.asarray(x)[iperm] - x_exact)
        assert err < 1e-7


class TestFGMRES64:
    def test_ilut_gmres_hi_one_pass(self):
        H, x_exact, b, A32, perm, Hp, Hp32 = _dh(11)
        pt = ILUTPreconditionerType(1e-3, 15, trisolve_mode="block")
        pp = pt.prep(Hp32)
        (out,) = fused_build([pp[0]])
        M = pp[1](out)
        A64 = pst.EllMatrix.from_host_csr(Hp, dtype=np.float64)
        bp = b[perm].astype(np.float64)
        iperm = np.empty(len(perm), dtype=np.int64)
        iperm[perm] = np.arange(len(perm))
        x, st, _ = ir_solve_dd(Hp.matvec, bp, A_lo=A32, A64=A64,
                               tau=1e-10, inner_maxiter=200, method="gmres",
                               restart=60, precond_pair=M.traced,
                               overshoot=0.005)
        assert int(st.reason) == 1
        assert int(st.k) <= 20       # f64 FGMRES: no restart-chain waste
        err = np.linalg.norm(np.asarray(x)[iperm] - x_exact)
        assert err < 1e-7
        rel = (np.linalg.norm(bp - Hp.matvec(np.asarray(x)))
               / np.linalg.norm(bp))
        assert rel <= 1e-11
