"""Structured-grid geometric multigrid: gather-free V-cycles.

The sparse GMG executor (gmg.py) stores the interpolation operators as
sparse matrices, whose SpMV needs gathers (the rectangular transfers
don't band-pack).  On a uniform 1-D/2-D Dirichlet grid the transfers
are *structured*: prolongation is interleave + neighbor averaging,
restriction is full weighting — pure strided slicing and adds, no
gathers at all.  Level operators are stencils, so they ride the
gather-free DIA SpMV.  The entire V-cycle is therefore gather-free
(reference analog: the stashed mesh-refinement GMG,
`stash/GMGVCycleSolver.py:16-28`, built on scipy SpMV).

Exactness contract: `grid_prolong` / `grid_restrict` compute exactly the
same linear maps as `gmg.interp_1d/interp_2d` and the row-normalized
transpose (`amg.make_restriction`), so the Galerkin hierarchy from
`gmg.build_gmg_hierarchy` applies unchanged (tests pin this equality).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import matvec
from ..ops.spmv import dia_spmm
from ..sparse.device import DiaMatrix
from ..sparse.host import HostCSR
from .amg import MLHierarchy, _smooth
from .gmg import build_gmg_hierarchy


# ---------------------------------------------------------------------------
# Grid transfer kernels (strided slicing — no gathers, no scatters)
# ---------------------------------------------------------------------------

def _prolong_last(X: jax.Array, m_f: int) -> jax.Array:
    """Linear interpolation along the last axis: (..., m_c) → (..., m_f)
    with m_f = 2·m_c + 1 (gmg.interp_1d's map).

    fine[2c+1] = coarse[c]; fine[2k] = (coarse[k−1] + coarse[k])/2 with
    Dirichlet zeros outside.  Built by interleaving the midpoint and
    coincident streams (stack + reshape — XLA lowers this to cheap
    layout ops, not scatter).
    """
    m_c = X.shape[-1]
    pad = [(0, 0)] * (X.ndim - 1)
    xp = jnp.pad(X, pad + [(1, 1)])                      # (..., m_c+2)
    even = 0.5 * (xp[..., :-1] + xp[..., 1:])            # (..., m_c+1)
    odd = jnp.pad(X, pad + [(0, 1)])                     # (..., m_c+1)
    out = jnp.stack([even, odd], axis=-1)                # (..., m_c+1, 2)
    return out.reshape(X.shape[:-1] + (2 * m_c + 2,))[..., :m_f]


def _restrict_last(X: jax.Array) -> jax.Array:
    """Full weighting along the last axis: (..., m_f) → (..., m_c).

    coarse[c] = fine[2c]/4 + fine[2c+1]/2 + fine[2c+2]/4 — exactly the
    row-normalized transpose of `_prolong_last` (make_restriction)."""
    e = X[..., 0::2]                                     # (..., m_c+1)
    o = X[..., 1::2]                                     # (..., m_c)
    return 0.5 * o + 0.25 * (e[..., :-1] + e[..., 1:])


def grid_prolong(x: jax.Array, ndim: int, m_c: int, m_f: int) -> jax.Array:
    """Interpolate a flat interior-grid vector coarse → fine."""
    if ndim == 1:
        return _prolong_last(x, m_f)
    X = x.reshape(m_c, m_c)
    X = _prolong_last(X, m_f)                            # along axis 1
    X = _prolong_last(X.T, m_f).T                        # along axis 0
    return X.reshape(m_f * m_f)


def grid_restrict(x: jax.Array, ndim: int, m_f: int, m_c: int) -> jax.Array:
    """Full-weighting restriction of a flat interior-grid vector."""
    if ndim == 1:
        return _restrict_last(x)
    X = x.reshape(m_f, m_f)
    X = _restrict_last(X)
    X = _restrict_last(X.T).T
    return X.reshape(m_c * m_c)


# ---------------------------------------------------------------------------
# Device hierarchy
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GridLevel:
    A_dev: object                    # DIA stencil operator
    dinv: jax.Array                  # 1/diag for Jacobi/Chebyshev
    gs_plan: object                  # unused (grid executor: jacobi/cheb)
    cheb: Optional[tuple]            # (theta, delta) for Chebyshev


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GridHierarchy:
    """Registered pytree (rides as a traced jit argument, like
    amg.DeviceHierarchy — re-built same-shape hierarchies reuse one
    compiled graph)."""

    levels: List[GridLevel]          # coarsest-first; levels[0] unused
    A0_inv: jax.Array                # coarsest dense inverse
    ms: tuple = dataclasses.field(metadata=dict(static=True))
    ndim: int = dataclasses.field(metadata=dict(static=True))
    smoother: str = dataclasses.field(metadata=dict(static=True))
    nu_pre: int = dataclasses.field(metadata=dict(static=True))
    nu_post: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_levels(self):
        return len(self.levels)


def build_grid_hierarchy(A: Optional[HostCSR], num_levels: int,
                         dims: Tuple[int, ...], smoother: str = "jacobi",
                         nu_pre: int = 2, nu_post: int = 2,
                         dtype=np.float32,
                         mlh: Optional[MLHierarchy] = None,
                         galerkin: str = "host") -> GridHierarchy:
    """Galerkin hierarchy (gmg.build_gmg_hierarchy) lowered as DIA
    stencils; the coarsest dense inverse and every upload ride ONE fused
    dispatch (ops/fuse.py).  Smoothers: "jacobi" (ω=2/3) or "chebyshev"
    (GS needs triangular solves — use the sparse executor for that).

    Pass ``mlh`` to lower an already-built Galerkin sequence (the OO
    shell's hierarchy hook); otherwise it is built from ``A``.

    ``galerkin``: "host" computes coarse operators by host SpGEMM and
    uploads every level; "device" probes them on device from the fine
    DIA operator (`build_grid_hierarchy_device` — no host SpGEMM, no
    coarse uploads); "auto" means "host"."""
    if galerkin == "auto":
        galerkin = "host"
    if galerkin == "device":
        if mlh is not None:
            raise ValueError("galerkin='device' builds from the fine "
                             "operator; it cannot lower a pre-built mlh")
        if A is None:
            raise ValueError("galerkin='device' requires the fine "
                             "operator A")
        A_dev = DiaMatrix.from_host_csr(A, dtype=dtype)
        return build_grid_hierarchy_device(A_dev, num_levels, dims,
                                           smoother, nu_pre, nu_post)
    if galerkin != "host":
        raise ValueError("galerkin must be 'host', 'device' or 'auto' "
                         "(got %r)" % (galerkin,))
    if smoother == "auto":
        smoother = "jacobi"      # the gather-free executor's native choice
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError("grid executor supports smoother='jacobi' or "
                         "'chebyshev' (got %r)" % (smoother,))
    if mlh is None:
        mlh = build_gmg_hierarchy(A, num_levels, dims)
    n_lev = mlh.n_levels
    # interior-point counts per level, coarsest-first (mlh order)
    ndim = len(dims)
    n_of = (lambda m: m) if ndim == 1 else (lambda m: m * m)
    ms = []
    for M in mlh.matrices:
        m_here = M.shape[0] if ndim == 1 else int(round(M.shape[0] ** 0.5))
        if n_of(m_here) != M.shape[0]:
            raise ValueError("level size %d is not a %d-D interior grid"
                             % (M.shape[0], ndim))
        ms.append(m_here)

    from ..ops.fuse import SetupItem, fused_build, passthrough_build
    from ..ops.dense_inverse import inv_from_coo_build

    items: list = []

    def _defer(item):
        items.append(item)
        return len(items) - 1

    plans = []
    for k, M in enumerate(mlh.matrices):
        if k == 0:
            # coarsest: dense inverse only — also when it is the ONLY
            # level (v_cycle_grid then just applies A0_inv; packing a
            # DIA operator for it would upload dead weight)
            plans.append(None)
            continue
        d = M.diagonal()
        d = np.where(d == 0, 1.0, d)
        # host-built DIA streams; the (n_diags, n_pad) table uploads in
        # the fused blob and lands as a passthrough
        Ad = DiaMatrix.from_host_csr(
            HostCSR(M.indptr, M.indices, M.data.astype(dtype), M.shape),
            dtype=dtype)
        diags_host = np.asarray(Ad.diags)
        i_diag = _defer(SetupItem((diags_host,), passthrough_build, ()))
        i_dinv = _defer(SetupItem(((1.0 / d).astype(dtype),),
                                  passthrough_build, ()))
        cheb = None
        if smoother == "chebyshev":
            from .preconditioner import ChebyshevPreconditionerType
            lmax = ChebyshevPreconditionerType().estimate_lmax(M)
            lmin = lmax / 30.0
            cheb = (0.5 * (lmax + lmin), 0.5 * (lmax - lmin))
        plans.append((i_diag, Ad.offsets, M.shape, i_dinv, cheb))

    A0_h = mlh.matrices[0]
    nc = A0_h.shape[0]
    r0, c0, v0 = A0_h.to_coo()
    i_inv = _defer(SetupItem((r0.astype(np.int32), c0.astype(np.int32),
                              v0.astype(dtype)),
                             inv_from_coo_build,
                             (nc, jnp.dtype(dtype).name)))

    outs = fused_build(items)

    levels: List[GridLevel] = []
    for k, plan in enumerate(plans):
        if plan is None:
            levels.append(GridLevel(None, None, None, None))
            continue
        i_diag, offsets, shape, i_dinv, cheb = plan
        A_dev = DiaMatrix(outs[i_diag], offsets, shape)
        levels.append(GridLevel(A_dev, outs[i_dinv], None, cheb))
    return GridHierarchy(levels, outs[i_inv], tuple(ms), ndim,
                         smoother, nu_pre, nu_post)


# ---------------------------------------------------------------------------
# Device-probed Galerkin: build coarse stencils ON DEVICE, no host SpGEMM
# ---------------------------------------------------------------------------

def _stencil_reach(offsets, m: int, ndim: int) -> int:
    """Per-dimension reach of a DIA stencil on an m-wide interior grid.

    2-D flat offsets decode as off = da·m + db with |db| ≪ m (stencil
    widths are tiny against the grid)."""
    r = 0
    for off in offsets:
        if ndim == 1:
            da, db = 0, off
        else:
            db = ((off + m // 2) % m) - m // 2
            da = (off - db) // m
        r = max(r, abs(da), abs(db))
    if r > m // 2:
        # the modular decode above is only unambiguous for reach <= m/2;
        # a wider stencil probed onto this grid would alias comb teeth
        # and silently corrupt the probed coarse operator
        raise ValueError("stencil reach %d exceeds m//2 = %d on an "
                         "m=%d grid — too wide to probe" % (r, m // 2, m))
    return r


def _probe_coarse_dia(A_f: DiaMatrix, ndim: int, m_f: int,
                      m_c: int) -> DiaMatrix:
    """Coarse Galerkin operator A_c = R·A_f·P extracted by comb probing —
    all on device, no host SpGEMM, no coarse-level upload.

    P/R are the structured transfers (grid_prolong/grid_restrict), so
    columns of A_c are exactly (R A_f P)·e_c.  Probe with comb vectors
    (one 1 every ``s`` points per dimension, s = 2·reach+1): combs are
    far enough apart that responses of distinct columns never overlap,
    so s^ndim applications of the gather-free pipeline recover EVERY
    column.  Diagonal extraction is a tiny one-hot einsum per offset —
    reshape/mask ops only, nothing gathers.  (This is the structured-
    grid answer to the reference's scipy SpGEMM triple product,
    MLHierarchy.py:54.)
    """
    r_f = _stencil_reach(A_f.offsets, m_f, ndim)
    rc = (r_f + 2) // 2                    # |k-c| <= (r_f+2)/2 coarse pts
    s = 2 * rc + 1
    dtype = A_f.dtype
    n_c = m_c ** ndim
    ar = jnp.arange(m_c)

    def pipeline_batch(V):
        """(K, n_c) comb batch → (K, n_c) responses: batch-aware strided
        transfers + the blocked DIA SpMM — ONE matrix pass for all
        combs."""
        K = V.shape[0]
        if ndim == 1:
            U = _prolong_last(V, m_f)                     # (K, m_f)
        else:
            X = V.reshape(K, m_c, m_c)
            X = _prolong_last(X, m_f)                     # axis -1
            X = _prolong_last(X.swapaxes(-1, -2), m_f).swapaxes(-1, -2)
            U = X.reshape(K, m_f ** ndim)
        W = dia_spmm(A_f, U.T).T                          # (K, n_f)
        if ndim == 1:
            return _restrict_last(W)
        X = W.reshape(K, m_f, m_f)
        X = _restrict_last(X)
        X = _restrict_last(X.swapaxes(-1, -2)).swapaxes(-1, -2)
        return X.reshape(K, n_c)

    deltas = range(-rc, rc + 1)
    if ndim == 1:
        combs = jnp.stack([(ar % s == p).astype(dtype) for p in range(s)],
                          axis=0)                          # (s, m_c)
        Y = pipeline_batch(combs)                          # (s, m_c)
        offsets, diags = [], []
        for da in deltas:
            # row a holds A_c[a, a-da]; its column's comb phase is (a-da)%s
            oh = jax.nn.one_hot((ar - da) % s, s, dtype=dtype)  # (m_c, s)
            D = jnp.einsum("ap,pa->a", oh, Y,
                           precision=jax.lax.Precision.HIGHEST)
            D = D * ((ar - da >= 0) & (ar - da < m_c)).astype(dtype)
            offsets.append(-da)
            diags.append(D)
    else:
        phases = [(px, py) for px in range(s) for py in range(s)]
        combs = jnp.stack(
            [((ar % s == px)[:, None] * (ar % s == py)[None, :])
             .astype(dtype).reshape(-1) for px, py in phases], axis=0)
        if m_f ** ndim > (1 << 23):
            # huge grids: one batch of all s^2 combs materializes
            # (n_f, s^2) temps — several GB each at n=1e8.  lax.map over
            # s-sized chunks SEQUENCES the pipeline (a Python-loop
            # chunking leaves XLA free to overlap the chunks and the
            # peak comes right back).
            Y = jax.lax.map(pipeline_batch,
                            combs.reshape(s, s, -1)).reshape(s * s, -1)
        else:
            Y = pipeline_batch(combs)
        Yps = Y.reshape(s, s, m_c, m_c)                    # (px, py, a, b)
        offsets, diags = [], []
        for da in deltas:
            oh_a = jax.nn.one_hot((ar - da) % s, s, dtype=dtype)
            va = ((ar - da >= 0) & (ar - da < m_c)).astype(dtype)
            for db in deltas:
                oh_b = jax.nn.one_hot((ar - db) % s, s, dtype=dtype)
                vb = ((ar - db >= 0) & (ar - db < m_c)).astype(dtype)
                D = jnp.einsum("ap,bq,pqab->ab", oh_a, oh_b, Yps,
                               precision=jax.lax.Precision.HIGHEST)
                D = D * va[:, None] * vb[None, :]
                offsets.append(-(da * m_c + db))
                diags.append(D.reshape(-1))
    order = np.argsort(offsets)
    n_pad = _ceil_to(n_c, 8)
    table = jnp.zeros((len(offsets), n_pad), dtype=dtype)
    table = table.at[:, :n_c].set(jnp.stack([diags[i] for i in order]))
    return DiaMatrix(table, tuple(int(offsets[i]) for i in order),
                     (n_c, n_c))


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _build_device_levels(fine_diags: jax.Array, fine_offsets, ms,
                         ndim: int, need_cheb: bool):
    """Jittable: probe every coarse level from the fine DIA table, with
    1/diag per level and the coarsest dense inverse — ONE dispatch."""
    from ..ops.dense_inverse import dense_inverse

    n_f = ms[-1] ** ndim
    A = DiaMatrix(fine_diags, fine_offsets, (n_f, n_f))
    ops = [A]                              # finest-first while probing
    for k in range(len(ms) - 1, 0, -1):    # ms is coarsest-first
        ops.append(_probe_coarse_dia(ops[-1], ndim, ms[k], ms[k - 1]))
    ops = ops[::-1]                        # coarsest-first, like ms

    out_levels = []
    for k in range(1, len(ms)):
        Ak = ops[k]
        n_k = Ak.shape[0]
        d = Ak.diags[Ak.offsets.index(0), :n_k]
        d = jnp.where(d == 0, 1.0, d)
        cheb = None
        if need_cheb:
            # Gershgorin bound for lambda_max of D^{-1}A straight off the
            # DIA table: max_i dinv_i * sum_d |A[i, i+off_d]|.  Always an
            # UPPER bound (power iteration under-estimates on the
            # clustered-top Laplacian spectrum — measured 1.94 vs true
            # 1.98, enough to make Chebyshev diverge on the top modes).
            rowsum = jnp.sum(jnp.abs(Ak.diags[:, :n_k]), axis=0)
            lmax = jnp.max(rowsum / jnp.abs(d))
            lmin = lmax / 30.0
            cheb = (0.5 * (lmax + lmin), 0.5 * (lmax - lmin))
        out_levels.append((Ak.diags, 1.0 / d, cheb))

    A0 = ops[0]
    n0 = A0.shape[0]
    dense0 = dia_spmm(A0, jnp.eye(n0, dtype=A0.dtype))
    A0_inv = dense_inverse(dense0)
    return out_levels, A0_inv


_DEVICE_BUILD_CACHE: dict = {}

# above this fine-level size the whole-hierarchy one-dispatch build is
# split into per-level jitted probes: the per-level graphs compile
# separately (and can be checkpointed), and at that scale a handful of
# extra dispatches is noise
_SPLIT_BUILD_N = 1 << 21


def _probe_level_fn(fine_offsets, m_f, m_c, ndim):
    """Cached per-level jit: fine DIA table -> coarse DIA table."""
    key = ("lvl", fine_offsets, m_f, m_c, ndim)
    fn = _DEVICE_BUILD_CACHE.get(key)
    if fn is not None:
        return fn

    @jax.jit
    def fn(diags):
        n_f = m_f ** ndim
        A = DiaMatrix(diags, fine_offsets, (n_f, n_f))
        return _probe_coarse_dia(A, ndim, m_f, m_c).diags

    if len(_DEVICE_BUILD_CACHE) > 32:
        _DEVICE_BUILD_CACHE.clear()
    _DEVICE_BUILD_CACHE[key] = fn
    return fn


def _level_stats_fn(offsets, n_k, need_cheb):
    """Cached jit: a level's own 1/diag (+ Gershgorin Chebyshev bounds)."""
    key = ("stats", offsets, n_k, need_cheb)
    fn = _DEVICE_BUILD_CACHE.get(key)
    if fn is None:
        zpos = offsets.index(0)

        @jax.jit
        def fn(diags):
            d = diags[zpos, :n_k]
            d = jnp.where(d == 0, 1.0, d)
            cheb = None
            if need_cheb:
                rowsum = jnp.sum(jnp.abs(diags[:, :n_k]), axis=0)
                lmax = jnp.max(rowsum / jnp.abs(d))
                lmin = lmax / 30.0
                cheb = (0.5 * (lmax + lmin), 0.5 * (lmax - lmin))
            return 1.0 / d, cheb

        _DEVICE_BUILD_CACHE[key] = fn
    return fn


def _coarsest_inverse_fn(offsets, n0):
    key = ("inv0", offsets, n0)
    fn = _DEVICE_BUILD_CACHE.get(key)
    if fn is None:
        from ..ops.dense_inverse import dense_inverse

        @jax.jit
        def fn(diags):
            A0 = DiaMatrix(diags, offsets, (n0, n0))
            dense0 = dia_spmm(A0, jnp.eye(n0, dtype=A0.dtype))
            return dense_inverse(dense0)

        _DEVICE_BUILD_CACHE[key] = fn
    return fn


def build_grid_hierarchy_device(A_dev: DiaMatrix, num_levels: int,
                                dims: Tuple[int, ...],
                                smoother: str = "jacobi",
                                nu_pre: int = 2,
                                nu_post: int = 2,
                                checkpoint: str = None) -> GridHierarchy:
    """GridHierarchy built entirely ON DEVICE from the (already-resident)
    fine DIA operator: coarse Galerkin levels by comb probing
    (`_probe_coarse_dia`), per-level 1/diag, Chebyshev bounds by a
    Gershgorin upper bound computed on device off the DIA table (NOT
    power iteration, which under-estimates λ_max on clustered-top
    spectra — unlike the host path's ``estimate_lmax``), and the
    coarsest dense inverse by blocked Gauss-Jordan — one jitted
    dispatch, nothing but the fine operator ever crosses the
    host↔device link.  The host path (`build_grid_hierarchy`) uploads
    every level it assembles.

    ``checkpoint``: .npz path for the PROBED PRODUCTS (coarse tables,
    coarsest inverse) on the split-build path — at n >= 1e8 the probe
    dispatches cost compile time per process, while the products are a
    few hundred MB that reload in seconds.  The file is validated against the
    fine operator's structure AND a device-computed value digest; a
    mismatch rebuilds and overwrites.  Ignored on the small fused path
    (setup there is already one cached dispatch).
    """
    if smoother == "auto":
        smoother = "jacobi"
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError("grid executor supports smoother='jacobi' or "
                         "'chebyshev' (got %r)" % (smoother,))
    from .gmg import refinement_ms
    ndim = len(dims)
    if ndim == 2 and dims[0] != dims[1]:
        raise ValueError("2-D GMG needs a square m×m grid (got %r)"
                         % (dims,))
    if A_dev.shape[0] != dims[0] ** ndim:
        raise ValueError("operator size %d does not match a %d-D grid of "
                         "width %d (expected %d)"
                         % (A_dev.shape[0], ndim, dims[0],
                            dims[0] ** ndim))
    ms = tuple(refinement_ms(dims[0], num_levels))[::-1]   # coarsest-first
    need_cheb = smoother == "chebyshev"

    if A_dev.shape[0] > _SPLIT_BUILD_N:
        # per-level dispatches (see _SPLIT_BUILD_N)
        loaded = None
        if checkpoint is not None:
            loaded = _try_load_hier_ckpt(checkpoint, A_dev, ms, ndim,
                                         need_cheb)
        if loaded is not None:
            out_levels, A0_inv = loaded
        else:
            out_levels = []
            tbl = A_dev.diags
            offs = A_dev.offsets
            for k in range(len(ms) - 1, 0, -1):    # fine -> coarse
                dinv, cheb = _level_stats_fn(offs, ms[k] ** ndim,
                                             need_cheb)(tbl)
                out_levels.append((tbl, dinv, cheb))
                tbl = _probe_level_fn(offs, ms[k], ms[k - 1], ndim)(tbl)
                offs = _probed_offsets(A_dev.offsets, ms, ndim, k - 1)
            A0_inv = _coarsest_inverse_fn(offs, ms[0] ** ndim)(tbl)
            out_levels.reverse()                   # coarsest-first
            if checkpoint is not None:
                _save_hier_ckpt(checkpoint, out_levels, A0_inv, A_dev,
                                ms, ndim, need_cheb)
    else:
        key = (A_dev.offsets, ms, ndim, need_cheb, str(A_dev.dtype))
        fn = _DEVICE_BUILD_CACHE.get(key)
        if fn is None:
            fn = jax.jit(functools.partial(
                _build_device_levels, fine_offsets=A_dev.offsets, ms=ms,
                ndim=ndim, need_cheb=need_cheb))
            if len(_DEVICE_BUILD_CACHE) > 16:
                _DEVICE_BUILD_CACHE.clear()
            _DEVICE_BUILD_CACHE[key] = fn
        out_levels, A0_inv = fn(A_dev.diags)

    levels: List[GridLevel] = [GridLevel(None, None, None, None)]
    for k in range(1, len(ms)):
        tbl, dinv, cheb = out_levels[k - 1]
        n_k = ms[k] ** ndim
        offs = _probed_offsets(A_dev.offsets, ms, ndim, k)
        Ak = DiaMatrix(tbl, offs, (n_k, n_k))
        levels.append(GridLevel(Ak, dinv, None,
                                tuple(cheb) if cheb is not None else None))
    return GridHierarchy(levels, A0_inv, ms, ndim, smoother,
                         nu_pre, nu_post)


def _hier_fingerprint(diags) -> np.ndarray:
    """Two-f64-reduction value digest of the fine DIA table, computed on
    device, so the n=1e8 table is never fetched to the host to hash."""
    f = jax.jit(lambda t: jnp.stack([
        jnp.sum(t, dtype=jnp.float64),
        jnp.sum(jnp.abs(t), dtype=jnp.float64)]))
    return np.asarray(f(diags))


def _save_hier_ckpt(path, out_levels, A0_inv, A_dev, ms, ndim,
                    need_cheb):
    """Persist the probed products: every COARSE level's (table, dinv,
    cheb) plus the coarsest inverse.  The fine table itself (out_levels'
    last entry — multi-GB, analytically re-assemblable by the caller) is
    deliberately not stored; its stats are recomputed on load (one
    elementwise pass).  Atomic write (tmp + rename)."""
    import os
    arrays = dict(
        meta_ms=np.asarray(ms, dtype=np.int64),
        meta_ndim=np.asarray([ndim], dtype=np.int64),
        meta_cheb=np.asarray([int(need_cheb)], dtype=np.int64),
        meta_offsets=np.asarray(A_dev.offsets, dtype=np.int64),
        meta_dtype=np.frombuffer(
            str(A_dev.dtype).encode(), dtype=np.uint8),
        meta_fp=_hier_fingerprint(A_dev.diags),
        A0_inv=np.asarray(A0_inv),
    )
    for k, (tbl, dinv, cheb) in enumerate(out_levels[:-1]):
        arrays[f"tbl_{k}"] = np.asarray(tbl)
        arrays[f"dinv_{k}"] = np.asarray(dinv)
        if cheb is not None:
            arrays[f"cheb_{k}"] = np.asarray(cheb)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _try_load_hier_ckpt(path, A_dev, ms, ndim, need_cheb):
    """Reload probed products if ``path`` matches this fine operator
    (structure + device value digest, rtol 1e-9 — distinct matrices
    differ at O(1), cross-backend reductions at O(eps)); else None and
    the caller re-probes + overwrites."""
    import os
    if not os.path.exists(path):
        return None
    try:
        d = np.load(path)
        if (tuple(d["meta_ms"]) != tuple(ms)
                or int(d["meta_ndim"][0]) != ndim
                or bool(d["meta_cheb"][0]) != bool(need_cheb)
                or tuple(d["meta_offsets"]) != tuple(A_dev.offsets)
                or bytes(d["meta_dtype"]).decode()
                != str(A_dev.dtype)):
            return None
        fp = _hier_fingerprint(A_dev.diags)
        if not np.allclose(fp, d["meta_fp"], rtol=1e-9, atol=0):
            return None
        # out_levels carries len(ms)-1 entries (levels 1..L-1, coarsest
        # first); the LAST one is the fine level, recomputed below, so
        # the file stores len(ms)-2 coarse entries
        out_levels = []
        for k in range(len(ms) - 2):
            cheb = (tuple(d[f"cheb_{k}"]) if f"cheb_{k}" in d.files
                    else None)
            out_levels.append((jnp.asarray(d[f"tbl_{k}"]),
                               jnp.asarray(d[f"dinv_{k}"]), cheb))
        # fine-level stats: one elementwise pass, no probing
        dinv_f, cheb_f = _level_stats_fn(A_dev.offsets, ms[-1] ** ndim,
                                         need_cheb)(A_dev.diags)
        out_levels.append((A_dev.diags, dinv_f, cheb_f))
        return out_levels, jnp.asarray(d["A0_inv"])
    except (KeyError, ValueError, OSError):
        return None


def _probed_offsets(fine_offsets, ms, ndim: int, k: int):
    """Static offset tuple of level k (coarsest-first) as produced by the
    probing chain: the finest level keeps ``fine_offsets``; every probed
    level has the full reach-rc box pattern, sorted ascending."""
    if k == len(ms) - 1:
        return fine_offsets
    # reach chain: r_{next} = (r + 2) // 2, starting from the fine reach
    r = _stencil_reach(fine_offsets, ms[-1], ndim)
    for lev in range(len(ms) - 2, k - 1, -1):
        r = (r + 2) // 2
    m_k = ms[k]
    if ndim == 1:
        return tuple(sorted(-da for da in range(-r, r + 1)))
    return tuple(sorted(-(da * m_k + db)
                        for da in range(-r, r + 1)
                        for db in range(-r, r + 1)))


def v_cycle_grid(h: GridHierarchy, f: jax.Array, x: jax.Array) -> jax.Array:
    """One V-cycle with structured-grid transfers (level loop unrolled;
    same recursion as amg.v_cycle / reference VCycleManager.py:31-62)."""

    def run(k, f_k, x_k):
        if k == 0:
            return jnp.matmul(h.A0_inv.astype(f_k.dtype), f_k,
                              precision=jax.lax.Precision.HIGHEST)
        lev = h.levels[k]
        x_k = _smooth(lev, h.smoother, x_k, f_k, h.nu_pre)
        r = f_k - matvec(lev.A_dev, x_k)
        f_c = grid_restrict(r, h.ndim, h.ms[k], h.ms[k - 1])
        x_c = run(k - 1, f_c, jnp.zeros_like(f_c))
        x_k = x_k + grid_prolong(x_c, h.ndim, h.ms[k - 1], h.ms[k])
        x_k = _smooth(lev, h.smoother, x_k, f_k, h.nu_post)
        return x_k

    return run(h.n_levels - 1, f, x)


# stable per-num_iters apply functions (state rides as the traced
# argument): the refine-layer jit caches key on function identity, and
# the PERSISTENT compile cache keys on the traced HLO — sharing these
# between batteries and pysolvers_tpu.prime is what makes cache priming
# hit (same function -> same trace -> same cache entry)
_GRID_VC_APPLY_FNS: dict = {}


def grid_vc_apply(num_iters: int):
    """apply(state, r): ``num_iters`` grid V-cycles from a zero start —
    the GMG-as-preconditioner application (module-level identity, see
    comment above)."""
    fn = _GRID_VC_APPLY_FNS.get(num_iters)
    if fn is None:
        def fn(state, r):
            x = jnp.zeros_like(r)
            for _ in range(num_iters):
                x = v_cycle_grid(state, r, x)
            return x
        _GRID_VC_APPLY_FNS[num_iters] = fn
    return fn
