"""Structured-grid GMG executor: transfer exactness vs the sparse
operators, V-cycle equivalence with the sparse executor, and solver
convergence (reference analogs: stash/GMGVCycleSolver.py,
VCycleManager.py:31-62)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pysolvers_tpu as pst
from pysolvers_tpu.linear.amg import (build_device_hierarchy, v_cycle,
                                      make_restriction)
from pysolvers_tpu.linear.gmg import (build_gmg_hierarchy, interp_1d,
                                      interp_2d)
from pysolvers_tpu.linear.gmg_grid import (build_grid_hierarchy,
                                           grid_prolong, grid_restrict,
                                           v_cycle_grid)
from pysolvers_tpu.linear.refine import ir_solve_dd
from pysolvers_tpu.sparse.device import DiaMatrix


@pytest.mark.parametrize("m_c", [3, 7, 15])
def test_grid_transfers_match_sparse_1d(m_c):
    m_f = 2 * m_c + 1
    P = interp_1d(m_f, m_c)
    R = make_restriction(P)
    rng = np.random.default_rng(0)
    xc = rng.random(m_c)
    xf = rng.random(m_f)
    np.testing.assert_allclose(
        np.asarray(grid_prolong(jnp.asarray(xc), 1, m_c, m_f)),
        P.matvec(xc), rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        np.asarray(grid_restrict(jnp.asarray(xf), 1, m_f, m_c)),
        R.matvec(xf), rtol=0, atol=1e-14)


@pytest.mark.parametrize("m_c", [3, 7])
def test_grid_transfers_match_sparse_2d(m_c):
    m_f = 2 * m_c + 1
    P = interp_2d(m_f, m_c)
    R = make_restriction(P)
    rng = np.random.default_rng(1)
    xc = rng.random(m_c * m_c)
    xf = rng.random(m_f * m_f)
    np.testing.assert_allclose(
        np.asarray(grid_prolong(jnp.asarray(xc), 2, m_c, m_f)),
        P.matvec(xc), rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        np.asarray(grid_restrict(jnp.asarray(xf), 2, m_f, m_c)),
        R.matvec(xf), rtol=0, atol=1e-14)


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_vcycle_grid_matches_sparse_executor(smoother):
    m = 15
    A = pst.problems.fd_laplacian_2d(m)
    mlh = build_gmg_hierarchy(A, num_levels=3, dims=(m, m))
    hs = build_device_hierarchy(mlh, smoother=smoother, nu_pre=2,
                                nu_post=2, dtype=np.float64)
    hg = build_grid_hierarchy(A, num_levels=3, dims=(m, m),
                              smoother=smoother, dtype=np.float64)
    rng = np.random.default_rng(2)
    f = jnp.asarray(rng.random(m * m))
    x0 = jnp.zeros(m * m)
    ys = np.asarray(v_cycle(hs, f, x0))
    yg = np.asarray(v_cycle_grid(hg, f, x0))
    # same hierarchy, same smoothers, same transfers — only fp
    # reassociation differs (chebyshev lmax power iteration on identical
    # host matrices gives identical params)
    np.testing.assert_allclose(yg, ys, rtol=1e-12, atol=1e-14)


def test_pcg_grid_gmg_converges_mixed():
    m = 31
    A = pst.problems.fd_laplacian_2d(m)
    n = m * m
    rng = np.random.default_rng(3)
    x_exact = rng.random(n)
    b = A.matvec(x_exact)
    hier = build_grid_hierarchy(A, num_levels=3, dims=(m, m),
                                smoother="jacobi", dtype=np.float32)
    A32 = DiaMatrix.from_host_csr(
        pst.HostCSR(A.indptr, A.indices, A.data.astype(np.float32),
                    A.shape))
    A64 = DiaMatrix.from_host_csr(A, dtype=np.float64)

    def _vc2(state, r):
        x = jnp.zeros_like(r)
        for _ in range(2):
            x = v_cycle_grid(state, r, x)
        return x

    x, st, _ = ir_solve_dd(A.matvec, b, A_lo=A32, A64=A64, tau=1e-10,
                           inner_tau=1e-6, inner_maxiter=60, method="cg",
                           precond_pair=(_vc2, hier), chain=4)
    rel = float(st.resid) / np.linalg.norm(b)
    assert rel <= 1e-10
    assert np.linalg.norm(np.asarray(x) - x_exact) < 1e-7 * np.linalg.norm(
        x_exact)


def test_grid_hierarchy_1d():
    m = 31
    A = pst.problems.fd_laplacian_1d(m)
    hier = build_grid_hierarchy(A, num_levels=3, dims=(m,),
                                smoother="jacobi", dtype=np.float64)
    mlh = build_gmg_hierarchy(A, num_levels=3, dims=(m,))
    hs = build_device_hierarchy(mlh, smoother="jacobi", dtype=np.float64)
    rng = np.random.default_rng(4)
    f = jnp.asarray(rng.random(m))
    ys = np.asarray(v_cycle(hs, f, jnp.zeros(m)))
    yg = np.asarray(v_cycle_grid(hier, f, jnp.zeros(m)))
    np.testing.assert_allclose(yg, ys, rtol=1e-12, atol=1e-14)


def test_gmg_factory_grid_executor():
    """OO shell: GMGVCycle(matrix_format="grid") runs the stationary
    V-cycle solver on the gather-free grid executor (reference
    VCycleExample.py:22-25 pattern on the stashed GMG intent)."""
    from pysolvers_tpu import GMGVCycle, SolverConfig
    m = 31
    A = pst.problems.fd_laplacian_2d(m)
    rng = np.random.default_rng(5)
    x_exact = rng.random(m * m)
    b = A.matvec(x_exact)
    s = GMGVCycle(SolverConfig(maxiter=60, tau=1e-10), dims=(m, m),
                  num_levels=3, smoother="jacobi", nu_pre=2, nu_post=2,
                  matrix_format="grid").make_solver()
    st = s.solve(A, b)
    assert st.success
    assert np.linalg.norm(np.asarray(st.soln) - x_exact) < 1e-7


def test_gmg_factory_grid_executor_default_smoother():
    """The default smoother='auto' must work on the grid executor too
    (regression: it was resolved only in the sparse hierarchy builder,
    so the grid path raised ValueError on the default)."""
    from pysolvers_tpu import GMGVCycle, SolverConfig
    m = 31
    A = pst.problems.fd_laplacian_2d(m)
    rng = np.random.default_rng(6)
    x_exact = rng.random(m * m)
    s = GMGVCycle(SolverConfig(maxiter=60, tau=1e-10), dims=(m, m),
                  num_levels=3, matrix_format="grid").make_solver()
    st = s.solve(A, A.matvec(x_exact))
    assert st.success
    assert np.linalg.norm(np.asarray(st.soln) - x_exact) < 1e-7


def test_gmg_preconditioner_type_in_pcg_factory():
    """GMGPreconditionerType drives PCG through the factory API (the GMG
    counterpart of reference PCGExample_AMG.py:20-22)."""
    from pysolvers_tpu import PCG, CommonSolverArgs, GMGPreconditionerType
    m = 31
    A = pst.problems.fd_laplacian_2d(m)
    rng = np.random.default_rng(6)
    x_exact = rng.random(m * m)
    b = A.matvec(x_exact)
    s = PCG(CommonSolverArgs(maxiter=100, tau=1e-10),
            precond=GMGPreconditionerType((m, m), num_iters=2,
                                          num_levels=3)).make_solver()
    st = s.solve(A, b)
    assert st.success
    assert np.linalg.norm(np.asarray(st.soln) - x_exact) < 1e-7


def test_grid_executor_rejects_gs():
    m = 7
    A = pst.problems.fd_laplacian_2d(m)
    with pytest.raises(ValueError):
        build_grid_hierarchy(A, 2, dims=(m, m), smoother="gs")


# ---------------------------------------------------------------------------
# Device-probed Galerkin (build_grid_hierarchy_device)
# ---------------------------------------------------------------------------

from pysolvers_tpu.linear.gmg_grid import build_grid_hierarchy_device


@pytest.mark.parametrize("ndim,m,levels", [(1, 31, 3), (2, 15, 3),
                                           (2, 31, 4)])
def test_device_probed_hierarchy_matches_host(ndim, m, levels):
    """Comb probing on device recovers EXACTLY the host SpGEMM Galerkin
    levels (same transfers, same operator — only fp reassociation)."""
    if ndim == 1:
        A = pst.problems.fd_laplacian_1d(m)
        dims = (m,)
    else:
        A = pst.problems.fd_laplacian_2d(m)
        dims = (m, m)
    hh = build_grid_hierarchy(A, num_levels=levels, dims=dims,
                              smoother="jacobi", dtype=np.float64)
    A_dev = DiaMatrix.from_host_csr(A, dtype=np.float64)
    hd = build_grid_hierarchy_device(A_dev, levels, dims,
                                     smoother="jacobi")
    assert hd.ms == hh.ms and hd.n_levels == hh.n_levels
    for k in range(1, levels):
        Lh, Ld = hh.levels[k], hd.levels[k]
        # host tables only carry the nonzero offsets; probed tables carry
        # the full reach box — compare entry-by-entry through a dict
        n_k = Ld.A_dev.shape[0]
        host = {o: np.asarray(Lh.A_dev.diags[i][:n_k])
                for i, o in enumerate(Lh.A_dev.offsets)}
        for i, o in enumerate(Ld.A_dev.offsets):
            want = host.get(o, np.zeros(n_k))
            np.testing.assert_allclose(
                np.asarray(Ld.A_dev.diags[i][:n_k]), want,
                rtol=0, atol=1e-12, err_msg=f"level {k} offset {o}")
        np.testing.assert_allclose(np.asarray(Ld.dinv),
                                   np.asarray(Lh.dinv), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(hd.A0_inv),
                               np.asarray(hh.A0_inv), rtol=0, atol=1e-10)


def test_device_probed_vcycle_solves():
    """PCG with the device-probed hierarchy converges like the host one."""
    m = 31
    A = pst.problems.fd_laplacian_2d(m)
    A_dev = DiaMatrix.from_host_csr(A, dtype=np.float64)
    hd = build_grid_hierarchy_device(A_dev, 3, (m, m), smoother="jacobi")
    rng = np.random.default_rng(3)
    x_exact = rng.random(m * m)
    b = jnp.asarray(A.matvec(x_exact))

    def papply(v):
        x = jnp.zeros_like(v)
        for _ in range(2):
            x = v_cycle_grid(hd, v, x)
        return x

    x, st, _ = pst.cg_solve(lambda v: pst.matvec(A_dev, v),
                            jnp.asarray(b), tau=1e-10, maxiter=50,
                            precond=papply)
    assert int(st.reason) == 1
    assert np.linalg.norm(np.asarray(x) - x_exact) < 1e-7


def test_device_probed_chebyshev_bounds():
    """The device Gershgorin upper bound gives usable Chebyshev bounds
    and the smoother converges."""
    m = 15
    A = pst.problems.fd_laplacian_2d(m)
    A_dev = DiaMatrix.from_host_csr(A, dtype=np.float64)
    hd = build_grid_hierarchy_device(A_dev, 2, (m, m),
                                     smoother="chebyshev")
    lev = hd.levels[-1]
    theta, delta = (float(np.asarray(t)) for t in lev.cheb)
    # D^{-1}A of the 2-D Laplacian has eigenvalues in (0, 2)
    lmax = theta + delta
    assert 1.5 < lmax < 2.5 and delta > 0
    rng = np.random.default_rng(4)
    x_exact = rng.random(m * m)
    b = jnp.asarray(A.matvec(x_exact))
    x = jnp.zeros(m * m)
    for _ in range(40):
        x = v_cycle_grid(hd, b, x)
    assert np.linalg.norm(np.asarray(x) - x_exact) < 1e-6


def test_gmg_precond_type_device_galerkin():
    """GMGPreconditionerType(galerkin='device') forms from the resident
    DIA operator and drives PCG to tolerance through the factory API."""
    m = 31
    A = pst.problems.fd_laplacian_2d(m)
    prec = pst.GMGPreconditionerType((m, m), num_iters=2, num_levels=3,
                                     smoother="jacobi", galerkin="device")
    control = pst.CommonSolverArgs(maxiter=50, tau=1e-10)
    st = pst.PCG(control, precond=prec).make_solver().solve(A, A.matvec(
        np.ones(m * m)))
    assert st.success
    assert np.linalg.norm(np.asarray(st.soln) - 1.0) < 1e-7


def test_device_hierarchy_checkpoint_roundtrip(tmp_path, monkeypatch):
    """Split-path probed products persist and reload: the warm process
    skips every probe dispatch (at n>=1e8 each process would otherwise
    compile and dispatch every probe again) and the
    loaded hierarchy V-cycles bit-identically.  A value change must
    invalidate the file (digest check) and rebuild."""
    from pysolvers_tpu.linear import gmg_grid as gg
    from pysolvers_tpu.problems import fd_laplacian_2d

    monkeypatch.setattr(gg, "_SPLIT_BUILD_N", 100)   # force split path
    probes = {"n": 0}
    real_probe = gg._probe_level_fn

    def spy(*a, **kw):
        probes["n"] += 1
        return real_probe(*a, **kw)

    monkeypatch.setattr(gg, "_probe_level_fn", spy)

    m = 31
    H = fd_laplacian_2d(m, dtype=np.float32)
    A = DiaMatrix.from_host_csr(H)
    ck = str(tmp_path / "hier.npz")

    h1 = gg.build_grid_hierarchy_device(A, 3, (m, m), checkpoint=ck)
    assert probes["n"] > 0
    import os
    assert os.path.exists(ck)

    probes["n"] = 0
    h2 = gg.build_grid_hierarchy_device(A, 3, (m, m), checkpoint=ck)
    assert probes["n"] == 0                  # warm: no probe dispatches

    rng = np.random.default_rng(0)
    f = jnp.asarray(rng.random(m * m).astype(np.float32))
    y1 = np.asarray(gg.v_cycle_grid(h1, f, jnp.zeros_like(f)))
    y2 = np.asarray(gg.v_cycle_grid(h2, f, jnp.zeros_like(f)))
    np.testing.assert_array_equal(y1, y2)

    # different values -> digest mismatch -> rebuild (and overwrite)
    A2 = DiaMatrix(A.diags * 2.0, A.offsets, A.shape)
    probes["n"] = 0
    h3 = gg.build_grid_hierarchy_device(A2, 3, (m, m), checkpoint=ck)
    assert probes["n"] > 0
    y3 = np.asarray(gg.v_cycle_grid(h3, f, jnp.zeros_like(f)))
    assert not np.array_equal(y1, y3)
