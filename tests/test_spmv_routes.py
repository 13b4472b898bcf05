"""Device SpMV/SpMM routes against the host f64 CSR product, the choice
of route per format, and the precision of the f32 products.

Tolerances (relative to max_i (|A||x|)_i, the scale of an SpMV's
rounding error): 1e-5 for f32 — an f32 sum of at most 9 terms taken in
another order than the host's; 1e-12 for f64.  The f32 cases compare
against the host product of the same f32-rounded data.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pysolvers_tpu as pst
from pysolvers_tpu.linear.gmg import interp_2d, make_restriction
from pysolvers_tpu.ops import matmat, matvec
from pysolvers_tpu.ops.spmv import bdia_spmm, bdia_spmm_rows, bdia_spmv
from pysolvers_tpu.problems.fem import (fem_poisson_2d_unstructured,
                                        graph_laplacian_rgg)
from pysolvers_tpu.sparse.host import HostCSR

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _nine_point(m):
    """9-point Laplacian stencil on an m×m grid (offsets ±1, ±m, ±m±1)."""
    idx = np.arange(m * m)
    i, j = idx // m, idx % m
    rows, cols, vals = [idx], [idx], [np.full(m * m, 8.0)]
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            if di == dj == 0:
                continue
            ok = (i + di >= 0) & (i + di < m) & (j + dj >= 0) & (j + dj < m)
            rows.append(idx[ok])
            cols.append(idx[ok] + di * m + dj)
            vals.append(np.full(ok.sum(), -1.0))
    return HostCSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                            np.concatenate(vals), (m * m, m * m))


def _wide_band(n=600, seed=0):
    """Banded matrix with offsets reaching ±250 (most rows of x shifted
    far out of the local neighbourhood)."""
    rng = np.random.default_rng(seed)
    offs = np.array([-250, -97, -3, 0, 1, 40, 250])
    rows, cols = [], []
    for off in offs:
        r = np.arange(max(0, -off), min(n, n - off))
        rows.append(r)
        cols.append(r + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return HostCSR.from_coo(rows, cols, rng.standard_normal(len(rows)),
                            (n, n))


DIA_CASES = {
    "tridiagonal": lambda: pst.problems.fd_laplacian_1d(300),
    "5-point": lambda: pst.problems.fd_laplacian_2d(23),
    "9-point": lambda: _nine_point(19),
    "prolongation": lambda: interp_2d(15, 7),
    "restriction": lambda: make_restriction(interp_2d(15, 7),
                                            normalize=False),
    "wide-band": lambda: _wide_band(),
}


def _rounded(H, dtype):
    return HostCSR(H.indptr, H.indices, H.data.astype(dtype), H.shape)


def _abs_scale(H, X):
    Habs = HostCSR(H.indptr, H.indices, np.abs(H.data).astype(np.float64),
                   H.shape)
    X = np.abs(np.asarray(X, dtype=np.float64))
    if X.ndim == 1:
        return Habs.matvec(X).max()
    return max(Habs.matvec(X[:, j]).max() for j in range(X.shape[1]))


def _check(H, Y, X):
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        ref = H.matvec(X)
    else:
        ref = np.stack([H.matvec(X[:, j]) for j in range(X.shape[1])],
                       axis=1)
    return float(np.abs(np.asarray(Y, dtype=np.float64) - ref).max()
                 / _abs_scale(H, X))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_spmv_matches_host(case, dtype):
    H = _rounded(DIA_CASES[case](), dtype)
    A = pst.DiaMatrix.from_host_csr(H)
    x = np.random.default_rng(1).standard_normal(H.shape[1]).astype(dtype)
    y = jax.jit(matvec)(A, jnp.asarray(x))
    assert y.shape == (H.shape[0],) and y.dtype == dtype
    assert _check(H, y, x) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(DIA_CASES))
def test_dia_spmm_matches_host(case, dtype):
    H = _rounded(DIA_CASES[case](), dtype)
    A = pst.DiaMatrix.from_host_csr(H)
    X = np.random.default_rng(2).standard_normal(
        (H.shape[1], 3)).astype(dtype)
    Y = jax.jit(matmat)(A, jnp.asarray(X))
    assert Y.shape == (H.shape[0], 3)
    assert _check(H, Y, X) <= TOL[dtype]


def test_dia_pack_pads_rows_to_eight():
    """No pack-time padding beyond the 8-row granule."""
    H = pst.problems.fd_laplacian_1d(40_001)
    A = pst.DiaMatrix.from_host_csr(H)
    assert A.diags.shape == (3, 40_008)


ELL_CASES = {
    "fem": lambda: fem_poisson_2d_unstructured(20, seed=4),
    "rgg": lambda: graph_laplacian_rgg(700, seed=5),
}


@pytest.mark.parametrize("op", ["spmv", "spmm"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(ELL_CASES))
def test_ell_matches_host(case, dtype, op):
    H = _rounded(ELL_CASES[case](), dtype)
    A = pst.EllMatrix.from_host_csr(H)
    rng = np.random.default_rng(3)
    shape = (H.shape[1],) if op == "spmv" else (H.shape[1], 4)
    X = rng.standard_normal(shape).astype(dtype)
    Y = jax.jit(matvec if op == "spmv" else matmat)(A, jnp.asarray(X))
    assert Y.shape == ((H.shape[0],) if op == "spmv" else (H.shape[0], 4))
    assert _check(H, Y, X) <= TOL[dtype]


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("b", [2, 3, 5])
def test_bdia_xla_spmv_spmm(b, k):
    """Planar block-DIA: (n, k) columns, (k, n) rows and (for k=1) the
    single-vector SpMV all equal the host product."""
    H = pst.problems.fd_vector_laplacian_2d(9, b=b, coupling=0.1)
    A = pst.BdiaMatrix.from_host_csr(H, b=b)
    X = np.random.default_rng(b).standard_normal((H.shape[0], k))
    Xp = np.asarray(A.to_planar(jnp.asarray(X)))          # planar (n, k)
    Yp = np.asarray(jax.jit(bdia_spmm)(A, jnp.asarray(Xp)))
    assert _check(H, np.asarray(A.from_planar(jnp.asarray(Yp))), X) <= 1e-12
    Yr = np.asarray(jax.jit(bdia_spmm_rows)(A, jnp.asarray(Xp.T)))
    np.testing.assert_allclose(Yr.T, Yp, rtol=1e-13, atol=1e-13)
    if k == 1:
        y = np.asarray(jax.jit(bdia_spmv)(A, jnp.asarray(Xp[:, 0])))
        np.testing.assert_allclose(y, Yp[:, 0], rtol=1e-13, atol=1e-13)


FORMATS = {
    "dia": lambda H: pst.DiaMatrix.from_host_csr(H),
    "ell": lambda H: pst.EllMatrix.from_host_csr(H),
    "bdia": lambda H: pst.BdiaMatrix.from_host_csr(H, b=2),
}


@pytest.mark.parametrize("op", ["matvec", "matmat"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_no_pallas_call_on_gpu_backend(fmt, op, monkeypatch):
    """With the backend reported as a GPU, no format's route traces a
    Pallas kernel: every SpMV/SpMM is plain XLA."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    H = _rounded(pst.problems.fd_vector_laplacian_2d(8, b=2), np.float32)
    A = FORMATS[fmt](H)
    x = jnp.ones((H.shape[0],) if op == "matvec" else (H.shape[0], 8),
                 jnp.float32)
    jaxpr = jax.make_jaxpr(matvec if op == "matvec" else matmat)(A, x)
    assert "pallas_call" not in str(jaxpr)


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a (nested) jaxpr."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            vs = v if isinstance(v, (tuple, list)) else (v,)
            for w in vs:
                if hasattr(w, "eqns"):
                    out += _dot_precisions(w)
                elif hasattr(w, "jaxpr") and hasattr(w.jaxpr, "eqns"):
                    out += _dot_precisions(w.jaxpr)
    return out


def _is_highest(p):
    hi = jax.lax.Precision.HIGHEST
    return p == hi or (isinstance(p, tuple) and all(q == hi for q in p))


def _amg_coarse():
    from pysolvers_tpu.linear.amg import (build_device_hierarchy,
                                          build_sa_hierarchy, v_cycle)
    H = pst.problems.fd_laplacian_2d(12, dtype=np.float32)
    h = build_device_hierarchy(build_sa_hierarchy(H, 2), smoother="jacobi")
    return lambda f: v_cycle(h, f, jnp.zeros_like(f)), (H.shape[0],)


def _grid_vcycle():
    from pysolvers_tpu.linear.gmg_grid import (build_grid_hierarchy,
                                               v_cycle_grid)
    m = 15
    H = pst.problems.fd_laplacian_2d(m, dtype=np.float32)
    h = build_grid_hierarchy(H, 2, (m, m), dtype=np.float32)
    return lambda f: v_cycle_grid(h, f, jnp.zeros_like(f)), (m * m,)


def _grid_probe():
    from pysolvers_tpu.linear.gmg_grid import _probe_coarse_dia
    m = 15
    A = pst.DiaMatrix.from_host_csr(
        pst.problems.fd_laplacian_2d(m, dtype=np.float32))
    return (lambda d: _probe_coarse_dia(
        pst.DiaMatrix(d, A.offsets, A.shape), 2, m, 7).diags,
        A.diags.shape)


def _block_jacobi():
    from pysolvers_tpu.linear.block_precond import (
        BlockJacobiBdiaPreconditionerType)
    H = _rounded(pst.problems.fd_vector_laplacian_2d(6, b=2), np.float32)
    A = pst.BdiaMatrix.from_host_csr(H, b=2)
    apply_fn, state = BlockJacobiBdiaPreconditionerType().form(
        A_dev=A).traced
    return (lambda v: apply_fn(state, v)), (H.shape[0],)


def _arnoldi():
    from pysolvers_tpu.linear.arnoldi import arnoldi
    A = pst.DiaMatrix.from_host_csr(
        pst.problems.fd_laplacian_1d(40, dtype=np.float32))
    return (lambda q: arnoldi(lambda v: matvec(A, v), q, 5)[1]), (40,)


def _gmres():
    from pysolvers_tpu.linear.krylov import gmres_solve
    A = pst.DiaMatrix.from_host_csr(
        pst.problems.fd_laplacian_1d(40, dtype=np.float32))
    return (lambda b: gmres_solve(lambda v: matvec(A, v), b, maxiter=5,
                                  tau=1e-3)[0]), (40,)


PRODUCTS = {"amg_coarse_solve": _amg_coarse, "grid_vcycle": _grid_vcycle,
            "grid_probe": _grid_probe, "block_jacobi": _block_jacobi,
            "arnoldi": _arnoldi, "gmres_solution": _gmres}


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_f32_products_are_highest(name):
    """Every f32 matrix product on these paths states HIGHEST precision
    (a default-precision f32 product may run in TF32 on the card)."""
    fn, shape = PRODUCTS[name]()
    jaxpr = jax.make_jaxpr(fn)(jnp.ones(shape, jnp.float32)).jaxpr
    precs = _dot_precisions(jaxpr)
    assert precs, "no dot_general traced"
    assert all(_is_highest(p) for p in precs), precs
