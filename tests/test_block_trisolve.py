"""Block-banded exact trisolve (ops/block_trisolve.py).

Replaces the reference's SuperLU triangular-solve applications
(ICPreconditioner.py:61-63, ILUTPreconditioner.py:67,78) with an exact
dense-block matmul path; these tests pin exactness against the
level-scheduled solver and iteration-count parity inside PCG.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import pysolvers_tpu as pst
from pysolvers_tpu.sparse.host import HostCSR
from pysolvers_tpu.linear.ilu import (ict_factor, ilut_factor,
                                      ICPreconditionerType,
                                      ILUTPreconditionerType)
from pysolvers_tpu.ops.trisolve import build_trisolve_plan, trisolve
from pysolvers_tpu.ops.block_trisolve import (build_block_trisolve_plan,
                                              block_trisolve)


def _rcm_permuted_dh(lev):
    H, x_exact, b = pst.problems.dh_test_problem(lev)
    perm = H.rcm_perm()
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(len(perm))
    rows, cols, vals = H.to_coo()
    Hp = HostCSR.from_coo(iperm[rows], iperm[cols], vals, H.shape)
    return Hp, perm, iperm, x_exact, b


@pytest.mark.parametrize("bs", [64, 128, 256])
def test_block_trisolve_exact_vs_level(bs):
    Hp, *_ = _rcm_permuted_dh(10)
    H64 = HostCSR(Hp.indptr, Hp.indices, Hp.data.astype(np.float64),
                  Hp.shape)
    n = Hp.shape[0]
    v = jnp.asarray(np.random.default_rng(0).standard_normal(n))
    Lc = ict_factor(H64, 1e-4, 15)
    L, U = ilut_factor(H64, 1e-4, 15)
    cases = [(Lc, True, False), (Lc.transpose(), False, False),
             (L, True, True), (U, False, False)]
    for T, lower, unit in cases:
        ref = trisolve(build_trisolve_plan(T, lower=lower, unit_diag=unit,
                                           dtype=np.float64), v)
        plan = build_block_trisolve_plan(T, lower=lower, unit_diag=unit,
                                         bs=bs, dtype=np.float64)
        got = block_trisolve(plan, v)
        err = float(jnp.linalg.norm(got - ref) / jnp.linalg.norm(ref))
        assert err < 1e-12, (lower, unit, bs, err)


@pytest.mark.parametrize("n", [700, 1025, 4096])
def test_ic_derived_pair_matches_generic(n):
    """The IC plan pair that ships L once and derives the Lᵀ plan on
    device (build_ic_block_trisolve_plan_pair, flip_pad reversal) must
    match the generic two-upload pair exactly — including when n is not
    a multiple of the block size."""
    from pysolvers_tpu.ops.block_trisolve import (
        build_block_trisolve_plan_pair, build_ic_block_trisolve_plan_pair)
    rng = np.random.default_rng(42)
    bw = 300
    rows, cols, vals = [], [], []
    for i in range(n):
        lo = max(0, i - bw)
        cs = np.unique(np.append(rng.integers(lo, i + 1, size=4), i))
        for c in cs:
            rows.append(i)
            cols.append(c)
            vals.append(2.0 + rng.random() if c == i
                        else 0.1 * rng.standard_normal())
    L = HostCSR.from_coo(np.array(rows), np.array(cols), np.array(vals),
                         (n, n))
    b = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    pl_g, pu_g = build_block_trisolve_plan_pair(L, L.transpose())
    pl_d, pu_d = build_ic_block_trisolve_plan_pair(L)
    assert pu_d.flip_pad and pu_d.flip
    xg = block_trisolve(pu_g, block_trisolve(pl_g, b))
    xd = block_trisolve(pu_d, block_trisolve(pl_d, b))
    err = float(jnp.linalg.norm(xg - xd) / jnp.linalg.norm(xg))
    assert err < 1e-6, err


def test_block_trisolve_rejects_unbanded():
    # arrow matrix: last row dense -> block reach = nb-1, must be refused
    n = 1024
    rows = np.concatenate([np.arange(n), np.full(n - 1, n - 1)])
    cols = np.concatenate([np.arange(n), np.arange(n - 1)])
    vals = np.concatenate([np.full(n, 2.0), np.full(n - 1, 0.1)])
    T = HostCSR.from_coo(rows, cols, vals, (n, n))
    with pytest.raises(ValueError):
        build_block_trisolve_plan(T, lower=True, bs=64, max_p=4)


def test_pcg_ic_block_matches_level_iteration_count():
    """The block mode is exact, so PCG iteration counts must equal the
    exact level-scheduled parity mode (VERDICT r1 item 4)."""
    Hp, perm, iperm, x_exact, b = _rcm_permuted_dh(10)
    Hp32 = HostCSR(Hp.indptr, Hp.indices, Hp.data.astype(np.float32),
                   Hp.shape)
    from pysolvers_tpu.linear.krylov import cg_solve
    from pysolvers_tpu.sparse.device import EllMatrix
    from pysolvers_tpu.ops.spmv import matvec
    A = EllMatrix.from_host_csr(Hp32)
    bp = jnp.asarray(b[perm].astype(np.float32))
    mv = lambda v: matvec(A, v)

    iters = {}
    for mode in ("level", "block"):
        # pin drop_scale: the fill-budget auto-search runs only in block
        # mode (fill is bandwidth-free there), so "auto" would compare
        # DIFFERENT factors — this test is about apply exactness, so
        # both modes must factor identically
        M = ICPreconditionerType(1e-3, 15, trisolve_mode=mode,
                                 drop_scale=0.1).form(Hp32)
        x, st, _ = cg_solve(mv, bp, maxiter=200, tau=1e-5,
                            precond=M.apply_right)
        assert int(st.reason) == 1
        iters[mode] = int(st.k)
    assert abs(iters["block"] - iters["level"]) <= 1, iters


def test_gmres_ilut_block_converges():
    Hp, perm, iperm, x_exact, b = _rcm_permuted_dh(10)
    Hp32 = HostCSR(Hp.indptr, Hp.indices, Hp.data.astype(np.float32),
                   Hp.shape)
    from pysolvers_tpu.linear.krylov import gmres_solve
    from pysolvers_tpu.sparse.device import EllMatrix
    from pysolvers_tpu.ops.spmv import matvec
    A = EllMatrix.from_host_csr(Hp32)
    bp = jnp.asarray(b[perm].astype(np.float32))
    mv = lambda v: matvec(A, v)
    M = ILUTPreconditionerType(1e-3, 15, trisolve_mode="block").form(Hp32)
    x, st, _ = gmres_solve(mv, bp, maxiter=100, tau=1e-5,
                           precond=M.apply_right)
    assert int(st.reason) == 1


def test_inside_block_violation_raises():
    """An above-diagonal entry INSIDE a diagonal block passes a
    block-level reach check but corrupts the solve (silently masked by
    the tril mask) — must raise element-wise."""
    from pysolvers_tpu.ops.block_trisolve import build_block_trisolve_plan
    n = 8
    rows = np.concatenate([np.arange(n), [1]])
    cols = np.concatenate([np.arange(n), [2]])   # (1, 2): upper, same block
    vals = np.concatenate([np.full(n, 2.0), [0.5]])
    T = HostCSR.from_coo(rows, cols, vals, (n, n), sum_duplicates=False)
    import pytest
    with pytest.raises(ValueError, match="triangular"):
        build_block_trisolve_plan(T, lower=True, bs=4)
