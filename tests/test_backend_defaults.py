"""Backend-independent defaults and the routes that replaced the removed
kernel formats: "auto" options resolve alike on every backend, GMG levels
stay DIA, block-MG runs on DIA/ELL levels, the ILU modes degrade to
plain-JAX solves, and the compile-cache rule."""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pysolvers_tpu as pst
from pysolvers_tpu.sparse.host import HostCSR


@pytest.fixture(params=["cpu", "gpu"])
def backend(request, monkeypatch):
    """Run the test as if JAX reported this backend."""
    monkeypatch.setattr(jax, "default_backend", lambda: request.param)
    return request.param


def test_amg_auto_defaults(backend):
    """AMG "auto": host Galerkin, GS smoother, host coarse inverse."""
    from pysolvers_tpu.linear.amg import build_sa_hierarchy
    H = pst.problems.fd_laplacian_2d(20)
    prec = pst.AMG(num_iters=1, num_levels=2).form(H)
    h = prec.traced[1]
    assert h.smoother == "gs"
    assert h.levels[-1].gs_plan is not None
    A0 = build_sa_hierarchy(H, 2).matrices[0].to_dense()
    np.testing.assert_allclose(np.asarray(h.A0_inv), np.linalg.inv(A0),
                               rtol=1e-10, atol=1e-12)


def test_gmg_auto_galerkin_is_host(backend, monkeypatch):
    from pysolvers_tpu.linear import gmg_grid
    called = []
    monkeypatch.setattr(gmg_grid, "build_grid_hierarchy_device",
                        lambda *a, **k: called.append(1))
    m = 15
    H = pst.problems.fd_laplacian_2d(m)
    prec = pst.GMGPreconditionerType(dims=(m, m), num_levels=3).form(
        H, pst.DiaMatrix.from_host_csr(H))
    assert not called and prec.traced is not None


def test_ilu_auto_mode_is_level(backend):
    from pysolvers_tpu.linear.ilu import _resolve_trisolve_mode
    assert _resolve_trisolve_mode("auto") == "level"


@pytest.mark.parametrize("galerkin", ["host", "device"])
def test_gmg_levels_stay_dia(galerkin):
    """Grid-GMG levels are DiaMatrix on both Galerkin routes, and the two
    routes build the same operators."""
    from pysolvers_tpu.linear.gmg_grid import (build_grid_hierarchy,
                                               v_cycle_grid)
    m = 31
    H = pst.problems.fd_laplacian_2d(m)
    h = build_grid_hierarchy(H, 3, (m, m), galerkin=galerkin,
                             dtype=np.float64)
    for lev in h.levels[1:]:
        assert type(lev.A_dev) is pst.DiaMatrix
    ref = build_grid_hierarchy(H, 3, (m, m), galerkin="host",
                               dtype=np.float64)
    f = jnp.asarray(np.random.default_rng(0).random(m * m))
    np.testing.assert_allclose(
        np.asarray(v_cycle_grid(h, f, jnp.zeros_like(f))),
        np.asarray(v_cycle_grid(ref, f, jnp.zeros_like(f))),
        rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("b", [2, 3])
def test_bmg_on_ell_levels_converges(b):
    from pysolvers_tpu.linear.block_precond import (
        BlockMGBdiaPreconditionerType)
    H = pst.problems.fd_vector_laplacian_2d(24, b=b, coupling=0.2)
    A = pst.BdiaMatrix.from_host_csr(H, b=b)
    prec = BlockMGBdiaPreconditionerType().form(A_dev=A)
    for h in prec.traced[1]:
        for lev in h.levels[1:]:
            assert isinstance(lev.A_dev, (pst.DiaMatrix, pst.EllMatrix))
    x_true = np.random.default_rng(b).random(H.shape[0])
    rhs = H.matvec(x_true)
    st = pst.solve(A, rhs, tau=1e-10, maxiter=300, precond="bmg")
    assert st.success
    x = np.asarray(st.soln)
    assert np.linalg.norm(rhs - H.matvec(x)) <= 1.01e-10 * np.linalg.norm(rhs)
    assert st.iters < 60


def _spd(m=18):
    H = pst.problems.fd_laplacian_2d(m)
    return H, H.permute_symmetric(np.random.default_rng(0).permutation(
        H.shape[0]))


@pytest.mark.parametrize("kind", ["ic", "ilut"])
def test_ilu_jacobi_mode_preconditions(kind):
    from pysolvers_tpu.linear.ilu import (ICPreconditionerType,
                                          ILUTPreconditionerType)
    H, _ = _spd()
    T = ICPreconditionerType if kind == "ic" else ILUTPreconditionerType
    M = T(1e-3, 15, trisolve_mode="jacobi", sweeps=12).form(H)
    A = pst.DiaMatrix.from_host_csr(H)
    b = jnp.asarray(H.matvec(np.ones(H.shape[0])))
    mv = lambda v: pst.matvec(A, v)                       # noqa: E731
    solve = pst.gmres_solve if kind == "ilut" else pst.cg_solve
    _, st0, _ = solve(mv, b, maxiter=400, tau=1e-8)
    x, st1, _ = solve(mv, b, maxiter=400, tau=1e-8, precond=M.apply_right)
    assert int(st1.reason) == pst.StopReason.CONVERGED
    assert int(st1.k) < int(st0.k)


@pytest.mark.parametrize("kind", ["ic", "ilut"])
def test_ilu_block_request_degrades_to_level(kind):
    """An explicit "block" request whose factor is not banded enough
    warns and falls back to the exact level-scheduled solve."""
    from pysolvers_tpu.linear.ilu import (ICPreconditionerType,
                                          ILUTPreconditionerType)
    _, Hs = _spd(48)      # random permutation: no band left
    T = ICPreconditionerType if kind == "ic" else ILUTPreconditionerType
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        M = T(1e-3, 15, trisolve_mode="block").form(Hs)
    assert any("level-scheduled" in str(x.message) for x in w)
    L = T(1e-3, 15, trisolve_mode="level").form(Hs)
    v = jnp.asarray(np.random.default_rng(1).random(Hs.shape[0]))
    np.testing.assert_allclose(np.asarray(M.apply_right(v)),
                               np.asarray(L.apply_right(v)), rtol=1e-12)


@pytest.mark.parametrize("kind", ["ic", "ilut"])
def test_ilu_unknown_mode_refused(kind):
    from pysolvers_tpu.linear.ilu import (ICPreconditionerType,
                                          ILUTPreconditionerType)
    H, _ = _spd(8)
    T = ICPreconditionerType if kind == "ic" else ILUTPreconditionerType
    with pytest.raises(ValueError, match="trisolve_mode"):
        T(trisolve_mode="jacobi_bws").form(H)


def _record_config(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    return calls


def test_cache_dir_env_wins(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the program sets no cache path."""
    from pysolvers_tpu.utils.platform import enable_persistent_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_config(monkeypatch)
    enable_persistent_cache()
    assert calls == []


def test_cache_dir_default_is_repo(monkeypatch):
    """Unset: the cache is <repo>/.jax_cache, which .gitignore lists."""
    from pysolvers_tpu.utils.platform import enable_persistent_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_config(monkeypatch)
    enable_persistent_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert calls == [("jax_compilation_cache_dir",
                      os.path.join(root, ".jax_cache"))]
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_no_hardcoded_cache_path():
    """No other compile-cache path is set anywhere in the program."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = [os.path.join(root, f) for f in os.listdir(root)
             if f.endswith(".py")]
    for d in ("pysolvers_tpu", "benchmarks", "examples", "tests"):
        for dp, _, fs in os.walk(os.path.join(root, d)):
            files += [os.path.join(dp, f) for f in fs if f.endswith(".py")]
    hits = []
    for p in files:
        if p == os.path.abspath(__file__):
            continue
        with open(p) as f:
            text = f.read()
        if "jax_compilation_cache_dir\"," in text or "/tmp/" in text:
            hits.append(os.path.relpath(p, root))
    assert hits == [os.path.join("pysolvers_tpu", "utils", "platform.py")]
