"""Smoothed-aggregation algebraic multigrid: hierarchy setup, V-cycle
solver, and AMG-as-preconditioner.

Capability parity with the reference AMG stack:
* SA setup — strength-of-connection |a_ij| >= tol·sqrt(a_ii·a_jj), 3-phase
  greedy aggregation with level-dependent tolerance 0.08·0.5^(lvl−1),
  tentative prolongator, filtered matrix, weighted-Jacobi prolongator
  smoothing with omega = 2/3 (reference SmoothedAggregation.py:41-229).
* Hierarchy — per-level A, prolongators, restriction = row-normalized
  transpose, Galerkin coarse operator R·(A·P) (reference MLHierarchy.py:5-78).
* V-cycle — pre/post smoothing, coarse direct solve (reference
  VCycleManager.py:9-62); smoothers: weighted Jacobi, Gauss-Seidel
  (level-scheduled backward solve like the reference's triu-based GS,
  ClassicSmoothers.py:20-36), symmetric Gauss-Seidel ("sgs" — keeps the
  V-cycle SPD for PCG) and Chebyshev (matvec-only).
* AMG V-cycle solver + AMG preconditioner with fixed inner iterations and
  failOnMaxiter=False semantics (reference VCycleSolver.py:15-95,
  AMGPreconditioner.py:8-51); hierarchy freeze/reuse via the API shell's
  freeze_matrix (reference VCycleSolver.py:71-76).

Split: setup (aggregation, SpGEMM) is host phase; the V-cycle executes
fully on device — the level loop is unrolled over the static hierarchy, so
one jitted call runs the whole cycle.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import SolverConfig, SolveStatus, StopReason, make_status
from ..ops import matvec
from ..ops.trisolve import TriSolvePlan, build_trisolve_plan, trisolve
from ..sparse.device import DiaMatrix, EllMatrix
from ..sparse.host import HostCSR
from .preconditioner import Preconditioner, PreconditionerType
from ..api import (IterativeLinearSolver, IterativeLinearSolverType,
                   as_device_matrix)


# ---------------------------------------------------------------------------
# Setup phase (host)
# ---------------------------------------------------------------------------

def strength_neighbors(A: HostCSR, tol: float):
    """Strong-connection mask per nnz: |a_ij| >= tol·sqrt(a_ii·a_jj)."""
    rows, cols, vals = A.to_coo()
    d = np.abs(A.diagonal())
    d = np.where(d == 0, 1.0, d)
    thresh = tol * np.sqrt(d[rows] * d[cols])
    strong = np.abs(vals) >= thresh
    return rows, cols, strong


def build_aggregates(A: HostCSR, tol: float, strength=None) -> np.ndarray:
    """Greedy 3-phase aggregation (Vaněk-style).  Returns agg id per node
    (ids 0..n_agg-1).  ``strength``: optional precomputed
    ``strength_neighbors`` result (shared with ``filtered_matrix``)."""
    n = A.shape[0]
    rows, cols, strong = strength or strength_neighbors(A, tol)
    keep = strong & (rows != cols)
    srows, scols = rows[keep], cols[keep]
    # adjacency lists of the strength graph
    order = np.argsort(srows, kind="stable")
    srows, scols = srows[order], scols[order]
    ptr = np.searchsorted(srows, np.arange(n + 1))

    from ..utils import native
    res = native.aggregate(ptr, scols.astype(np.int32), n)
    if res is not None:
        return res[0]

    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    # phase 1: seed aggregates from fully-unaggregated neighborhoods
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = scols[ptr[i]: ptr[i + 1]]
        if (agg[nbrs] == -1).all():
            agg[i] = n_agg
            agg[nbrs] = n_agg
            n_agg += 1
    # phase 2: attach stragglers to an adjacent aggregate
    unagg = np.where(agg == -1)[0]
    for i in unagg:
        nbrs = scols[ptr[i]: ptr[i + 1]]
        hit = nbrs[agg[nbrs] != -1]
        if len(hit):
            agg[i] = agg[hit[0]]
    # phase 3: remaining isolated nodes form singletons
    for i in np.where(agg == -1)[0]:
        agg[i] = n_agg
        n_agg += 1
    return agg


def tentative_prolongator(agg: np.ndarray, dtype=np.float64) -> HostCSR:
    n = len(agg)
    n_agg = int(agg.max()) + 1 if n else 0
    return HostCSR.from_coo(np.arange(n), agg, np.ones(n, dtype=dtype),
                            (n, n_agg), sum_duplicates=False)


def filtered_matrix(A: HostCSR, tol: float, strength=None) -> HostCSR:
    """Drop weak off-diagonal couplings, lumping them onto the diagonal
    (keeps row sums — the standard SA filtering).  ``strength``: optional
    precomputed ``strength_neighbors`` result.

    Built directly from the CSR-ordered COO view: boolean filtering
    preserves row-major order, so no lexsort rebuild is needed, and the
    lump lands on the surviving diagonal entries in place — this was
    the DOMINANT SA setup cost at n=1.05M (5.1 s of an 11.6 s
    hierarchy via two from_coo/add rebuilds; now ~0.3 s)."""
    n = A.shape[0]
    rows, cols, strong = strength or strength_neighbors(A, tol)
    vals = A.data
    weak = (~strong) & (rows != cols)
    lump = np.zeros(n, dtype=vals.dtype)
    np.add.at(lump, rows[weak], vals[weak])
    keep = ~weak
    new_rows = rows[keep]
    new_cols = cols[keep]
    new_vals = vals[keep].copy()
    diag_mask = new_rows == new_cols
    diag_rows = new_rows[diag_mask]
    has_diag = np.zeros(n, dtype=bool)
    has_diag[diag_rows] = True
    if np.any(lump[~has_diag] != 0):
        # a row lost every entry incl. its diagonal slot (no stored
        # diagonal): rare/degenerate — keep the general rebuild path
        Af = HostCSR.from_coo(new_rows, new_cols, new_vals, A.shape,
                              sum_duplicates=False)
        d_idx = np.arange(n)
        return Af.add(HostCSR.from_coo(d_idx, d_idx, lump, A.shape),
                      alpha=1.0)
    new_vals[diag_mask] += lump[diag_rows]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(new_rows, minlength=n), out=indptr[1:])
    return HostCSR(indptr, new_cols.astype(np.int32), new_vals, A.shape)


def smooth_prolongator(A_f: HostCSR, P_hat: HostCSR, omega: float = 2.0 / 3.0
                       ) -> HostCSR:
    """P = (I − omega·D⁻¹·A_f)·P̂ (damped-Jacobi smoothing of the tentative
    prolongator; reference SmoothedAggregation.py:185-205)."""
    d = A_f.diagonal()
    d = np.where(d == 0, 1.0, d)
    DinvA = A_f.scale_rows(1.0 / d)
    AP = DinvA.matmat(P_hat)
    return P_hat.add(AP, alpha=-omega)


def make_restriction(P: HostCSR, normalize: bool = True) -> HostCSR:
    """R = Pᵀ, optionally row-sum normalized (reference MLHierarchy.py:60-78)."""
    R = P.transpose()
    if normalize:
        s = np.zeros(R.shape[0], dtype=R.data.dtype)
        rows, _, vals = R.to_coo()
        np.add.at(s, rows, vals)
        s = np.where(s == 0, 1.0, s)
        R = R.scale_rows(1.0 / s)
    return R


def sa_coarsen(A: HostCSR, lvl_tol: float, omega: float = 2.0 / 3.0):
    """One SA coarsening step: returns (P, R, A_coarse).

    R = Pᵀ UNNORMALIZED: row-sum normalizing Pᵀ (the reference's
    MLHierarchy.py:60-78 choice, kept behind ``make_restriction``'s
    flag) makes the Galerkin product A_c = R·A·P NON-symmetric whenever
    aggregate row sums vary — on structured grids the sums are uniform
    so the scaling is a harmless scalar, but on unstructured aggregates
    the coarse operators came out 10-20% asymmetric and the V-cycle
    stopped being a valid SPD preconditioner: PCG on the n=4.2M
    unstructured FEM problem stalled at rel 4e-2 after 30 iterations.
    With R = Pᵀ the same problem converges to 1e-10."""
    strength = strength_neighbors(A, lvl_tol)   # one O(nnz) pass, shared
    agg = build_aggregates(A, lvl_tol, strength=strength)
    P_hat = tentative_prolongator(agg, dtype=A.data.dtype)
    A_f = filtered_matrix(A, lvl_tol, strength=strength)
    P = smooth_prolongator(A_f, P_hat, omega)
    R = make_restriction(P, normalize=False)
    A_c = R.matmat(A.matmat(P))
    return P, R, A_c


@dataclasses.dataclass
class MLHierarchy:
    """Host-side hierarchy.  Level 0 = COARSEST (reference MLHierarchy.py:9-13)."""

    matrices: List[HostCSR]        # A per level, coarsest first
    prolongators: List[HostCSR]    # I_up[k]: level k-1 → k (len = n_levels-1)
    restrictions: List[HostCSR]    # I_down[k]: level k → k-1

    @property
    def n_levels(self):
        return len(self.matrices)


def build_sa_hierarchy(A: HostCSR, num_levels: int = 2,
                       base_tol: float = 0.08, min_coarse: int = 8,
                       coarsening: str = "sa") -> MLHierarchy:
    """Coarsen fine→coarse with tol schedule base_tol·0.5^(lvl−1)
    (reference SmoothedAggregation.py:62-63, hierarchy loop :20-22).

    ``coarsening``: "sa" (smoothed aggregation, the reference's production
    path) or "rs" (classical Ruge-Stüben, amg_rs.py — the reference's
    stashed intent)."""
    mats = [A]
    Ps: List[HostCSR] = []
    Rs: List[HostCSR] = []
    for lvl in range(1, num_levels):
        tol = base_tol * (0.5 ** (lvl - 1))
        A_cur = mats[-1]
        if A_cur.shape[0] <= min_coarse:
            break
        if coarsening == "rs":
            from .amg_rs import rs_coarsen
            P, R, A_c = rs_coarsen(A_cur)
        else:
            P, R, A_c = sa_coarsen(A_cur, tol)
        if A_c.shape[0] >= A_cur.shape[0]:
            break  # aggregation stalled
        mats.append(A_c)
        Ps.append(P)
        Rs.append(R)
    # reorder coarsest-first
    mats.reverse()
    Ps.reverse()
    Rs.reverse()
    return MLHierarchy(mats, Ps, Rs)


def build_sa_hierarchy_device(A: HostCSR, num_levels: int = 2,
                              smoother: str = "auto", nu_pre: int = 2,
                              nu_post: int = 2, base_tol: float = 0.08,
                              dtype=np.float32,
                              max_bytes: int = 1 << 31):
    """Single-chip unstructured SA hierarchy with the construction
    products built ON DEVICE — the general-Galerkin answer to the
    reference's scipy SpGEMM triple product (MLHierarchy.py:54) and
    prolongator smoothing (SmoothedAggregation.py:203).

    Only the O(nnz) graph aggregation runs on host; the smoothed
    prolongator P = (I − ω D_f⁻¹ A_f)·P̂, the triple product
    A_c = R·A·P and the coarse dense inverse are dense-panel device
    work (parallel/amg_setup.py::_setup_products — SA's one-aggregate-
    per-row structure makes the dense-tall prolongator exact, so the
    "sparse×sparse" runs as SpMM + one einsum contraction, no host
    SpGEMM and no coarse-operator upload).

    Memory gate: dense P is n×nc; beyond ``max_bytes`` use the host
    SpGEMM path (build_sa_hierarchy) or the structured-grid prober
    (gmg_grid.build_grid_hierarchy_device).  Returns a DeviceHierarchy
    (drop-in for v_cycle/amg_solve and the factories).
    """
    from ..parallel.amg_setup import build_distributed_hierarchy
    if smoother == "auto":
        smoother = "jacobi"      # device products provide jacobi/chebyshev
    return build_distributed_hierarchy(
        A, None, num_levels=num_levels, smoother=smoother, nu_pre=nu_pre,
        nu_post=nu_post, base_tol=base_tol, dtype=dtype,
        max_bytes=max_bytes)


# ---------------------------------------------------------------------------
# Device cycle executor
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DeviceLevel:
    A_dev: object                    # device matrix
    dinv: jax.Array                  # 1/diag for Jacobi/Chebyshev smoothing
    gs_plan: Optional[object]        # "gs": triu plan; "sgs": (tril, triu)
    P_dev: Optional[object]          # prolongator (to this level), None at 0
    R_dev: Optional[object]          # restriction (from this level)
    cheb: Optional[tuple]            # (theta, delta) for Chebyshev


# registered pytrees so a hierarchy can ride as a traced jit ARGUMENT:
# re-built same-structure hierarchies (e.g. per Newton step) then reuse
# one compiled graph (refine._cached_inner_pair)
@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DeviceHierarchy:
    levels: List[DeviceLevel]
    A0_inv: jax.Array                # coarsest operator inverse (dense)
    smoother: str = dataclasses.field(metadata=dict(static=True))
    nu_pre: int = dataclasses.field(metadata=dict(static=True))
    nu_post: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_levels(self):
        return len(self.levels)


def _pad_fine_level(mlh: MLHierarchy, n_pad: int) -> MLHierarchy:
    """Pad the finest operator to n_pad rows with a unit diagonal (the
    appended equations are decoupled: x_tail = f_tail) and extend the
    fine transfers with zero rows/columns.  Used by the ``mesh=`` path so
    row sharding divides evenly on odd problem sizes."""
    A = mlh.matrices[-1]
    n = A.shape[0]
    r, c, v = A.to_coo()
    extra = np.arange(n, n_pad)
    A_p = HostCSR.from_coo(np.concatenate([r, extra]),
                           np.concatenate([c, extra]),
                           np.concatenate([v, np.ones(len(extra),
                                                      dtype=v.dtype)]),
                           (n_pad, n_pad))
    mats = list(mlh.matrices[:-1]) + [A_p]
    Ps = list(mlh.prolongators)
    Rs = list(mlh.restrictions)
    if Ps:
        P = Ps[-1]          # (n, nc): pad rows — CSR shape change only
        Ps[-1] = HostCSR(np.concatenate([
            P.indptr, np.full(n_pad - n, P.indptr[-1],
                              dtype=P.indptr.dtype)]),
            P.indices, P.data, (n_pad, P.shape[1]))
        R = Rs[-1]          # (nc, n): pad cols — shape change only
        Rs[-1] = HostCSR(R.indptr, R.indices, R.data,
                         (R.shape[0], n_pad))
    return MLHierarchy(mats, Ps, Rs)


def build_device_hierarchy(mlh: MLHierarchy, smoother: str = "auto",
                           nu_pre: int = 2, nu_post: int = 2,
                           dtype=None, mesh=None) -> DeviceHierarchy:
    """Lower the host hierarchy onto the device(s).

    ``smoother``: "auto" (= "gs", reference parity), "jacobi", "gs",
    "sgs", or "chebyshev".

    ``mesh`` (optional): a 1-D jax Mesh — the FINEST level's operator,
    diagonal and vectors are row-sharded over it (gather-coarse policy:
    coarse levels stay replicated, standard for AMG where coarse work no
    longer fills the machine).  Transfers and smoother state on coarse
    levels are replicated; GSPMD inserts the collectives at the
    fine-level boundary.  Requires the fine level to be DIA or ELL."""
    if smoother == "auto":
        smoother = "gs"          # reference parity, ClassicSmoothers.py:20-36

    if mesh is not None:
        # GSPMD row sharding needs the fine dimension divisible by the
        # mesh; DH/GMG sizes are odd, so pad the FINE level with unit
        # diagonal rows at setup (decoupled x_tail = f_tail equations —
        # every cycle/solve below runs unchanged on the padded system).
        # Transfers: P gains zero rows, R zero columns (shape-only).
        n_dev = int(mesh.devices.size)
        n_fine = mlh.matrices[-1].shape[0]
        import math as _math
        unit = _math.lcm(8, n_dev)
        n_pad = ((n_fine + unit - 1) // unit) * unit
        if n_pad != n_fine:
            mlh = _pad_fine_level(mlh, n_pad)

    levels: List[DeviceLevel] = []
    for k, A in enumerate(mlh.matrices):
        if k == 0 and len(mlh.matrices) > 1:
            # the coarsest level solves via the dense inverse only —
            # its operator pack / smoother diagonal are never touched
            # by v_cycle (k==0 returns A0_inv @ f)
            levels.append(DeviceLevel(None, None, None, None, None, None))
            continue
        lvl_dtype = dtype or A.data.dtype
        d = A.diagonal()
        d = np.where(d == 0, 1.0, d)
        A_dev = as_device_matrix(A, dtype=dtype)[1]
        # match the level dtype: a bare f64 dinv would silently promote
        # every smoother op to f64
        dinv = jnp.asarray((1.0 / d).astype(lvl_dtype))
        gs_plan = None
        cheb = None
        if smoother == "gs" and k > 0:
            # reference GS: dx = triu(A)^{-1} r (ClassicSmoothers.py:28-36)
            gs_plan = build_trisolve_plan(A.extract_upper(), lower=False,
                                          dtype=lvl_dtype)
        if smoother == "sgs" and k > 0:
            # symmetric GS: M = (D+L) D^{-1} (D+U).  M is symmetric for
            # SPD A, so with nu_pre == nu_post the whole V-cycle is an
            # SPD operator — safe as a PCG preconditioner (the
            # one-directional "gs" V-cycle is nonsymmetric and can make
            # residual-replacement CG diverge at the f32 noise floor).
            gs_plan = (build_trisolve_plan(A.extract_lower(), lower=True,
                                           dtype=lvl_dtype),
                       build_trisolve_plan(A.extract_upper(), lower=False,
                                           dtype=lvl_dtype))
        if smoother == "chebyshev" and k > 0:
            from .preconditioner import ChebyshevPreconditionerType
            lmax = ChebyshevPreconditionerType().estimate_lmax(A)
            lmin = lmax / 30.0
            cheb = (0.5 * (lmax + lmin), 0.5 * (lmax - lmin))
        P_dev = R_dev = None
        if k > 0:
            P_dev = as_device_matrix(mlh.prolongators[k - 1], dtype=dtype)[1]
            R_dev = as_device_matrix(mlh.restrictions[k - 1], dtype=dtype)[1]
        if mesh is not None and k == len(mlh.matrices) - 1:
            from ..parallel.mesh import row_sharding, shard_operator_rows
            if isinstance(A_dev, (DiaMatrix, EllMatrix)):
                A_dev = shard_operator_rows(A_dev, mesh)
            dinv = jax.device_put(dinv, row_sharding(mesh))
        levels.append(DeviceLevel(A_dev, dinv, gs_plan, P_dev, R_dev, cheb))
    # coarse direct solve: host (LAPACK) inverse, applied on device as a
    # dense matvec
    A0_h = mlh.matrices[0]
    A0 = A0_h.to_dense().astype(np.float64)
    A0_inv = jnp.asarray(np.linalg.inv(A0), dtype=dtype or A0_h.data.dtype)
    return DeviceHierarchy(levels, A0_inv, smoother, nu_pre, nu_post)


def _smooth(level: DeviceLevel, smoother: str, x, f, sweeps: int):
    """sweeps applications of the level smoother to A x = f."""
    if smoother == "chebyshev":
        if sweeps <= 0:
            return x             # match jacobi/gs: zero sweeps = no-op
        # degree-`sweeps` Chebyshev iteration on D^{-1}A over [lmin, lmax]
        theta, delta = level.cheb
        dv = level.dinv.astype(x.dtype)
        r = f - matvec(level.A_dev, x)
        p = dv * r / theta
        x = x + p
        rho = delta / theta
        for _ in range(sweeps - 1):
            r = f - matvec(level.A_dev, x)
            rho_new = 1.0 / (2.0 * theta / delta - rho)
            p = rho_new * rho * p + (2.0 * rho_new / delta) * (dv * r)
            x = x + p
            rho = rho_new
        return x
    for _ in range(sweeps):
        r = f - matvec(level.A_dev, x)
        if smoother == "jacobi":
            x = x + (2.0 / 3.0) * level.dinv.astype(x.dtype) * r
        elif smoother == "gs":
            x = x + trisolve(level.gs_plan, r)
        elif smoother == "sgs":
            lo, up = level.gs_plan
            z = trisolve(lo, r)              # (D+L)^{-1} r
            z = z / level.dinv.astype(x.dtype)   # × D
            x = x + trisolve(up, z)          # (D+U)^{-1} ·
        else:
            raise ValueError(smoother)
    return x


def amg_solve(h: DeviceHierarchy, b: jax.Array, *, tau: float = 1e-8,
              maxiter: int = 100, norm_fn=None):
    """Stationary V-cycle iteration x ← V(b, x) under one ``lax.while_loop``
    (the fully-jitted counterpart of the reference's cycle loop,
    VCycleSolver.py:79-91).  Returns (x, (k, resid, reason))."""
    from ..core import StopReason
    norm = norm_fn or (lambda v: jnp.sqrt(jnp.sum(v * v)))
    A_top = h.levels[-1].A_dev
    b_norm = norm(b)
    tol = tau * b_norm

    def cond(c):
        return c[3] == StopReason.RUNNING

    def body(c):
        k, x, resid, reason = c
        x = v_cycle(h, b, x)
        r = b - matvec(A_top, x)
        resid = norm(r)
        k = k + 1
        reason = jnp.where(
            resid <= tol, StopReason.CONVERGED,
            jnp.where(~jnp.isfinite(resid), StopReason.BREAKDOWN,
                      jnp.where(k >= maxiter, StopReason.MAXITER,
                                StopReason.RUNNING))).astype(jnp.int32)
        return (k, x, resid, reason)

    x0 = jnp.zeros_like(b)
    init_reason = jnp.where(b_norm <= tol, StopReason.CONVERGED,
                            StopReason.RUNNING).astype(jnp.int32)
    k, x, resid, reason = jax.lax.while_loop(
        cond, body, (jnp.int32(0), x0, b_norm, init_reason))
    return x, (k, resid, reason)


def v_cycle(h: DeviceHierarchy, f: jax.Array, x: jax.Array) -> jax.Array:
    """One V-cycle; level loop unrolled over the static hierarchy.

    Structure parity: reference VCycleManager.runLevel (VCycleManager.py:31-62)
    — coarsest direct solve; else pre-smooth, restrict residual, recurse,
    prolong-correct, post-smooth.

    Accepts either hierarchy flavor: sparse-transfer ``DeviceHierarchy``
    or the gather-free structured-grid ``GridHierarchy`` (gmg_grid.py).
    """
    from .gmg_grid import GridHierarchy, v_cycle_grid
    if isinstance(h, GridHierarchy):
        return v_cycle_grid(h, f, x)

    def run(k, f_k, x_k):
        lev = h.levels[k]
        if k == 0:
            return jnp.matmul(h.A0_inv.astype(f_k.dtype), f_k,
                              precision=jax.lax.Precision.HIGHEST)
        x_k = _smooth(lev, h.smoother, x_k, f_k, h.nu_pre)
        r = f_k - matvec(lev.A_dev, x_k)
        f_c = matvec(lev.R_dev, r)
        x_c = run(k - 1, f_c, jnp.zeros_like(f_c))
        x_k = x_k + matvec(lev.P_dev, x_c)
        x_k = _smooth(lev, h.smoother, x_k, f_k, h.nu_post)
        return x_k

    return run(h.n_levels - 1, f, x)


# ---------------------------------------------------------------------------
# Solver + preconditioner shells
# ---------------------------------------------------------------------------

class AMGVCycle(IterativeLinearSolverType):
    """Factory for the AMG V-cycle stationary solver (reference
    VCycleSolver.py:15-36; defaults numLevels=2, nuPre=nuPost=2, GS)."""

    def __init__(self, control: Optional[SolverConfig] = None,
                 num_levels: int = 2, nu_pre: int = 2, nu_post: int = 2,
                 smoother: str = "auto", base_tol: float = 0.08, mesh=None,
                 matrix_format: str = "auto", galerkin: str = "host"):
        super().__init__(control, None)
        self.num_levels = num_levels
        self.nu_pre = nu_pre
        self.nu_post = nu_post
        self.smoother = smoother
        self.base_tol = base_tol
        # optional 1-D device mesh: shards the fine level (and the solve's
        # vectors) over the mesh — distributed AMG with coarse gathering
        self.mesh = mesh
        # "auto": DIA/ELL level operators; "grid" (GMG only): the
        # structured-grid executor (linear/gmg_grid.py)
        self.matrix_format = matrix_format
        # "device"/"auto": construction products on device
        # (build_sa_hierarchy_device); "host" keeps the host-SpGEMM
        # hierarchy (the GS-parity and mesh paths need it)
        self.galerkin = galerkin

    def make_solver(self):
        return AMGVCycleSolver(self)

    makeSolver = make_solver


class AMGVCycleSolver(IterativeLinearSolver):
    def __init__(self, typ: AMGVCycle):
        super().__init__(typ.control, typ.precond)
        self.typ = typ
        self._hierarchy: Optional[DeviceHierarchy] = None
        self._solve_jit = None

    def _build_mlh(self, A_host: HostCSR) -> MLHierarchy:
        """Hierarchy construction hook — geometric-MG subclasses override
        this (linear/gmg.py) while reusing the whole device cycle path."""
        return build_sa_hierarchy(A_host, self.typ.num_levels,
                                  self.typ.base_tol)

    def _build_device(self, mlh: MLHierarchy, dtype):
        """Device-lowering hook — the structured-grid executor
        (gmg.py ``matrix_format="grid"``) overrides this."""
        return build_device_hierarchy(
            mlh, self.typ.smoother, self.typ.nu_pre, self.typ.nu_post,
            dtype=dtype, mesh=self.typ.mesh)

    def _ensure_hierarchy(self, A_host: HostCSR, dtype):
        # hierarchy rebuilt unless matrix frozen (reference VCycleSolver.py:71-76)
        if self._hierarchy is not None and self.matrix_frozen():
            return
        if A_host is None:
            raise ValueError("AMG setup needs a HostCSR matrix")
        if getattr(self.typ, "galerkin", "host") == "device":
            if self.typ.mesh is not None:
                raise ValueError("galerkin='device' is the single-chip "
                                 "builder; use the mesh-aware "
                                 "build_distributed_hierarchy for mesh=")
            # build in the SOLVE dtype (the host path's contract): a
            # hardcoded f32 hierarchy caps an f64 stationary solve at
            # the ~1e-7 f32 V-cycle floor
            self._hierarchy = build_sa_hierarchy_device(
                A_host, self.typ.num_levels, smoother=self.typ.smoother,
                nu_pre=self.typ.nu_pre, nu_post=self.typ.nu_post,
                base_tol=self.typ.base_tol, dtype=np.dtype(dtype))
        else:
            mlh = self._build_mlh(A_host)
            self._hierarchy = self._build_device(mlh, dtype)
        h = self._hierarchy
        maxiter = self.control.maxiter
        norm_fn = self.control.norm_fn()

        def full_solve(b, tau):
            return amg_solve(h, b, tau=tau, maxiter=maxiter,
                             norm_fn=norm_fn)

        # tau is only compared against, so it traces (no recompiles when
        # Newton adapts the tolerance each step)
        self._solve_jit = jax.jit(full_solve)

    def solve(self, A, b) -> SolveStatus:
        # hierarchy setup needs only the HOST matrix — don't pack/upload
        # a device matrix this solver never applies (the V-cycle runs on
        # the hierarchy's own level operators)
        if isinstance(A, tuple):
            A_host = A[0]
        elif isinstance(A, HostCSR):
            A_host = A
        else:
            A_host, _ = self._split_matrix(A)
        b = jnp.asarray(b)
        n = b.shape[0]
        self._ensure_hierarchy(A_host, b.dtype)
        h = self._hierarchy
        if self.typ.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as PS
            from ..parallel.mesh import ROW_AXIS
            # fine level may be identity-padded for even sharding
            n_pad = h.levels[-1].A_dev.shape[0]
            if n_pad != n:
                b = jnp.concatenate([b, jnp.zeros(n_pad - n, b.dtype)])
            b = jax.device_put(b, NamedSharding(self.typ.mesh, PS(ROW_AXIS)))
        x, (k, resid, reason) = self._solve_jit(
            b, tau=self._effective_tau())
        if x.shape[0] != n:
            x = x[:n]

        class _S:
            pass

        st = _S()
        st.k, st.resid, st.reason = int(k), float(resid), int(reason)
        return make_status(x, st, self.control, history=None)


class AMGPreconditionerType(PreconditionerType):
    """AMG as a preconditioner: fixed number of V-cycles per application,
    maxiter-as-success semantics (reference AMGPreconditioner.py:8-51:
    maxiter=numIters, failOnMaxiter=False, matrix frozen)."""

    def __init__(self, num_iters: int = 5, num_levels: int = 2,
                 nu_pre: int = 2, nu_post: int = 2, smoother: str = "auto",
                 base_tol: float = 0.08, side: str = "both",
                 galerkin: str = "auto"):
        self.num_iters = num_iters
        self.num_levels = num_levels
        self.nu_pre = nu_pre
        self.nu_post = nu_post
        self.smoother = smoother
        self.base_tol = base_tol
        self.side = side
        # "device": construction products (smoothed P, R·A·P, coarse
        # inverse) built on device (build_sa_hierarchy_device); "host"
        # (= "auto"): host SpGEMM hierarchy
        self.galerkin = galerkin

    def form(self, A_host: HostCSR, A_dev=None) -> Preconditioner:
        if self.galerkin == "device":
            # build in the MATRIX dtype (the mixed factory route hands an
            # f32 host copy; an f64 caller keeps f64)
            h = build_sa_hierarchy_device(
                A_host, self.num_levels, smoother=self.smoother,
                nu_pre=self.nu_pre, nu_post=self.nu_post,
                base_tol=self.base_tol, dtype=A_host.data.dtype)
        else:
            from ..utils.timing import Timer
            with Timer("amg.host_hierarchy"):
                mlh = build_sa_hierarchy(A_host, self.num_levels,
                                         self.base_tol)
            with Timer("amg.device_lower"):
                h = build_device_hierarchy(
                    mlh, self.smoother, self.nu_pre, self.nu_post)
        apply_fn = _amg_apply_fn(self.num_iters)
        prec = self._wrap(lambda v: apply_fn(h, v))
        prec.traced = (apply_fn, h)
        return prec


_AMG_APPLY_FNS = {}


def _amg_apply_fn(num_iters: int):
    """Stable per-num_iters apply function (state rides as the argument) —
    the identity-keyed jit caches depend on this function being the SAME
    object across re-formed preconditioners."""
    fn = _AMG_APPLY_FNS.get(num_iters)
    if fn is None:
        def fn(h, v):
            x = jnp.zeros_like(v)
            for _ in range(num_iters):
                x = v_cycle(h, v, x)
            return x
        _AMG_APPLY_FNS[num_iters] = fn
    return fn


# reference-style short aliases (PCGExample_AMG.py uses AMG(...))
AMG = AMGPreconditionerType
