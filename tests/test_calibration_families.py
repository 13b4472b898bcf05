"""Calibration family-insensitivity (VERDICT r3 item 9).

The drop-scale auto-calibration must carry NO per-family constants: the
fill-slope exponent is measured per matrix (two-point probe in
ilu._resolve_drop_scale), and only the budget-fraction POLICY remains.
These tests pin preconditioned iteration counts within 1.3x of an f64
reference count on THREE families — DH (FEM), convection-diffusion at
several Péclet numbers, and the vector Laplacian — where the reference
count uses the reference's own engine: scipy's SuperLU spilu with the
reference's construction (ILUTPreconditioner.py:51-53 /
ICPreconditioner.py:40-56) inside our f64 CG/GMRES.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import pysolvers_tpu as pst
from pysolvers_tpu.linear.ilu import (ICPreconditionerType,
                                      ILUTPreconditionerType, _SCALE_CACHE)
from pysolvers_tpu.linear.krylov import cg_solve, gmres_solve
from pysolvers_tpu.ops import matvec
from pysolvers_tpu.sparse.host import HostCSR


def _scipy_csr(A: HostCSR):
    import scipy.sparse as sp
    return sp.csr_matrix((A.data, A.indices, A.indptr), shape=A.shape)


def _ref_ic_apply(A: HostCSR, drop_tol=1e-3, fill_factor=15.0):
    """Reference IC construction via SuperLU spilu
    (ICPreconditioner.py:40-56): no pivoting, natural ordering,
    L = (D^{-1/2} U)^T, apply = two triangular solves."""
    import scipy.sparse.linalg as spla
    S = _scipy_csr(A).tocsc()
    ilu = spla.spilu(S, drop_tol=drop_tol, fill_factor=fill_factor,
                     diag_pivot_thresh=0.0, permc_spec="NATURAL")
    U = ilu.U.tocsr()
    d = np.sqrt(U.diagonal())
    Lc = U.T.multiply(1.0 / d[None, :]).tocsr()   # L = (D^{-1/2} U)^T

    def apply(v):
        y = spla.spsolve_triangular(Lc, v, lower=True)
        return spla.spsolve_triangular(Lc.T.tocsr(), y, lower=False)

    return apply


def _ref_ilut_apply(A: HostCSR, drop_tol=1e-3, fill_factor=15.0):
    """Reference ILUT via spilu (ILUTPreconditioner.py:51-53)."""
    import scipy.sparse.linalg as spla
    S = _scipy_csr(A).tocsc()
    ilu = spla.spilu(S, drop_tol=drop_tol, fill_factor=fill_factor)
    return ilu.solve


def _ref_cg_iters(A, b, apply, tau=1e-10, maxiter=500):
    """Host f64 right-preconditioned CG, the reference recurrence
    (PCGSolver.py:109-138) with the reference's engine inside — the f64
    reference iteration count (runs scipy applies, so host numpy)."""
    S = _scipy_csr(A)
    b = np.asarray(b, dtype=np.float64)
    tol = tau * np.linalg.norm(b)
    x = np.zeros_like(b)
    r = b.copy()
    u = apply(r)
    udr = float(u @ r)
    p = u.copy()
    for k in range(1, maxiter + 1):
        Ap = S @ p
        alpha = udr / float(p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        if np.linalg.norm(r) <= tol:
            return k
        u = apply(r)
        udr_new = float(u @ r)
        p = u + (udr_new / udr) * p
        udr = udr_new
    raise AssertionError("reference CG did not converge")


def _ref_gmres_iters(A, b, apply, tau=1e-10, maxiter=500):
    """Host f64 right-preconditioned full GMRES (MGS + Givens), the
    reference recurrence (GMRESSolver.py:104-174)."""
    S = _scipy_csr(A)
    b = np.asarray(b, dtype=np.float64)
    n = len(b)
    m = maxiter
    beta = np.linalg.norm(b)
    tol = tau * beta
    Q = np.zeros((n, m + 1))
    Hm = np.zeros((m + 1, m))
    cs = np.zeros((m, 2))
    g = np.zeros(m + 1)
    Q[:, 0] = b / beta
    g[0] = beta
    for k in range(m):
        u = S @ np.asarray(apply(Q[:, k]))
        for j in range(k + 1):
            Hm[j, k] = Q[:, j] @ u
            u -= Hm[j, k] * Q[:, j]
        Hm[k + 1, k] = np.linalg.norm(u)
        if Hm[k + 1, k] > 0:
            Q[:, k + 1] = u / Hm[k + 1, k]
        for j in range(k):
            hj, hj1 = Hm[j, k], Hm[j + 1, k]
            Hm[j, k] = cs[j, 0] * hj + cs[j, 1] * hj1
            Hm[j + 1, k] = -cs[j, 1] * hj + cs[j, 0] * hj1
        rden = np.hypot(Hm[k, k], Hm[k + 1, k])
        cs[k] = (Hm[k, k] / rden, Hm[k + 1, k] / rden)
        Hm[k, k] = rden
        Hm[k + 1, k] = 0.0
        gk = g[k]
        g[k] = cs[k, 0] * gk
        g[k + 1] = -cs[k, 1] * gk
        if abs(g[k + 1]) <= tol:
            return k + 1
    raise AssertionError("reference GMRES did not converge")


def _our_iters(A, b, method):
    """Inner-iteration count of OUR mixed-precision route with the
    block trisolve mode (where the fill-budget
    search is active — retained fill is bandwidth-free there)."""
    _SCALE_CACHE.clear()
    control = pst.CommonSolverArgs(maxiter=500, tau=1e-10)
    if method == "cg":
        fac = pst.PCG(control, precond=ICPreconditionerType(
            trisolve_mode="block"), precision="mixed")
    else:
        fac = pst.GMRES(control, precond=ILUTPreconditionerType(
            trisolve_mode="block"), precision="mixed")
    st = fac.make_solver().solve(A, b)
    assert st.success
    return int(st.iters)


class TestFamilyInsensitiveCalibration:
    def test_dh_ic_within_1p3x(self):
        A, x_exact, b = pst.problems.dh_test_problem(10)
        ref = _ref_cg_iters(A, b, _ref_ic_apply(A))
        ours = _our_iters(A, b, "cg")
        assert ours <= max(1.3 * ref, ref + 2), (ours, ref)

    @pytest.mark.parametrize("peclet", [4.0, 25.0, 60.0])
    def test_convection_diffusion_ilut_within_1p3x(self, peclet):
        A = pst.problems.fd_convection_diffusion_2d(31, peclet, 0.5 * peclet)
        rng = np.random.default_rng(0)
        b = A.matvec(rng.random(A.shape[0]))
        ref = _ref_gmres_iters(A, b, _ref_ilut_apply(A))
        ours = _our_iters(A, b, "gmres")
        assert ours <= max(1.3 * ref, ref + 2), (ours, ref, peclet)

    def test_vector_laplacian_ic_within_1p3x(self):
        A = pst.problems.fd_vector_laplacian_2d(18, b=2, coupling=0.3)
        rng = np.random.default_rng(1)
        b = A.matvec(rng.random(A.shape[0]))
        ref = _ref_cg_iters(A, b, _ref_ic_apply(A))
        ours = _our_iters(A, b, "cg")
        assert ours <= max(1.3 * ref, ref + 2), (ours, ref)

    def test_unstructured_fem_ic_within_1p3x(self):
        # the round-4 unstructured family (problems/fem.py) — a fourth
        # family the constants were never tuned on
        from pysolvers_tpu.problems.fem import fem_poisson_2d_unstructured
        A0 = fem_poisson_2d_unstructured(24, seed=5)
        A = A0.permute_symmetric(A0.rcm_perm())
        rng = np.random.default_rng(2)
        b = A.matvec(rng.random(A.shape[0]))
        ref = _ref_cg_iters(A, b, _ref_ic_apply(A))
        ours = _our_iters(A, b, "cg")
        assert ours <= max(1.3 * ref, ref + 2), (ours, ref)

    def test_probe_measures_slope_not_constant(self):
        # the resolved scale differs across families when their fill
        # slopes differ — i.e. no hidden single constant
        from pysolvers_tpu.linear import ilu as ilu_mod
        _SCALE_CACHE.clear()
        A1, _, _ = pst.problems.dh_test_problem(10)
        ICPreconditionerType(1e-3, 15.0, trisolve_mode="block")._factor(A1)
        s_dh = {k: v for k, v in _SCALE_CACHE.items()}
        A2 = pst.problems.fd_convection_diffusion_2d(31, 25.0, 12.5)
        ILUTPreconditionerType(1e-3, 15.0,
                               trisolve_mode="block")._factor(A2)
        assert len(_SCALE_CACHE) > len(s_dh)
