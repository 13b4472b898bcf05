"""Thin OO shell: the reference's user-facing API surface over the
functional device core.

Parity map (reference → here):
  CommonSolverArgs (IterativeSolver.py:25-57)      → CommonSolverArgs
  LinearSolverType.makeSolver (LinearSolver.py:7-15)→ LinearSolverType.make_solver
  freezeMatrix/unfreezeMatrix (LinearSolver.py:35-42)→ same (snake_case + camelCase aliases)
  freezePrec/unfreezePrec (IterativeLinearSolver.py:79-86) → same
  PCG/PCGSolver (PCGSolver.py:25-145)              → PCG / PCGSolver
  GMRES/GMRESSolver (GMRESSolver.py:27-180)        → GMRES / GMRESSolver
  DefaultDirect (DefaultDirectSolver.py:23-74)     → DefaultDirect / solver
  mvmult (IterativeLinearSolver.py:94-106)         → pysolvers_tpu.ops.matvec

Matrices may be passed as HostCSR (auto-packed to the best device format),
as a device format (EllMatrix/DiaMatrix), as a numpy/dense array, or as a
(host, device) pair for full control.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from .core import SolverConfig, SolveStatus, StopReason, make_status
from .linear.krylov import cg_solve, gmres_solve
from .linear.preconditioner import (IdentityPreconditionerType,
                                    Preconditioner, PreconditionerType)
from .ops import matvec
from .sparse.device import DiaMatrix, EllMatrix
from .sparse.host import HostCSR


def CommonSolverArgs(maxiter: int = 100, tau: float = 1e-8,
                     failOnMaxiter: bool = True, norm: str = "2",
                     showIters: bool = False, showFinal: bool = False,
                     interval: int = 1, **kw) -> SolverConfig:
    """Reference-style constructor for SolverConfig (camelCase kwargs)."""
    return SolverConfig(maxiter=maxiter, tau=tau,
                        fail_on_maxiter=failOnMaxiter, norm=norm,
                        show_iters=showIters, show_final=showFinal,
                        interval=interval, **kw)


def _dd_chain_enabled() -> bool:
    """One-dispatch f64-residual refinement chains (refine.ir_solve_dd).

    Default on (needs x64 for the on-device f64 accumulator);
    PST_DD_CHAIN=0 reverts to per-pass host-residual refinement."""
    import os
    return (os.environ.get("PST_DD_CHAIN", "1") != "0"
            and bool(jax.config.jax_enable_x64))


def as_device_matrix(A, dtype=None):
    """Pick the best device format for a matrix: DIA for banded stencils,
    ELL otherwise.  Returns (A_host or None, A_dev)."""
    if isinstance(A, (EllMatrix, DiaMatrix)):
        return None, A
    if isinstance(A, HostCSR):
        if DiaMatrix.is_profitable(A):
            return A, DiaMatrix.from_host_csr(A, dtype=dtype)
        return A, EllMatrix.from_host_csr(A, dtype=dtype)
    if isinstance(A, np.ndarray) or isinstance(A, jax.Array):
        return None, jnp.asarray(A, dtype=dtype)
    if hasattr(A, "__matmul__") and getattr(A, "ndim", None) == 2:
        return None, A   # matrix-free operator (e.g. operator.LinearOperator)
    raise TypeError(f"cannot convert {type(A)} to a device matrix")


def _apply_unpadded(apply, n: int, v):
    """``apply`` on the first n rows of a shard-padded vector; the
    padding rows pass through unchanged."""
    return jnp.concatenate([apply(v[:n]).astype(v.dtype), v[n:]])


def _aggregate_multi(sts, control) -> SolveStatus:
    """One SolveStatus over per-column statuses: (n, k) soln, max
    iters/resid, success only if every column succeeded."""
    from .core import StopReason

    X = jnp.stack([jnp.asarray(st.soln) for st in sts], axis=1)
    failed = [st for st in sts if not st.success]
    return SolveStatus(
        success=not failed, soln=X,
        resid=max(float(st.resid) for st in sts),
        iters=max(int(st.iters) for st in sts),
        reason=failed[0].reason if failed else StopReason.CONVERGED,
        msg="; ".join(sorted({st.msg for st in sts if st.msg})))


# ---------------------------------------------------------------------------
# Base classes (factory split — reference LinearSolver.py:7-42)
# ---------------------------------------------------------------------------

class LinearSolverType:
    def make_solver(self):
        raise NotImplementedError

    # reference-style alias
    makeSolver = make_solver


class LinearSolver:
    def __init__(self):
        self._matrix_frozen = False

    def solve(self, A, b) -> SolveStatus:
        raise NotImplementedError

    def freeze_matrix(self):
        self._matrix_frozen = True

    def unfreeze_matrix(self):
        self._matrix_frozen = False

    def matrix_frozen(self) -> bool:
        return self._matrix_frozen

    freezeMatrix = freeze_matrix
    unfreezeMatrix = unfreeze_matrix
    matrixFrozen = matrix_frozen


class IterativeLinearSolverType(LinearSolverType):
    def __init__(self, control: Optional[SolverConfig] = None,
                 precond: Optional[PreconditionerType] = None,
                 precision: str = "native", mesh=None):
        self.control = control or SolverConfig()
        self.precond = precond or IdentityPreconditionerType()
        # "native": solve in the matrix dtype on device.  "mixed": inner
        # Krylov in f32 (half the operator bytes) + f64 residual
        # refinement (linear/refine.py) to reach 1e-10-grade accuracy.
        if precision not in ("native", "mixed"):
            raise ValueError(f"precision must be 'native' or 'mixed', "
                             f"got {precision!r}")
        self.precision = precision
        # optional jax.sharding.Mesh: shards the operator, the vectors and
        # the solve over the mesh's row axis (parallel/).  None = single
        # device.
        self.mesh = mesh


class IterativeLinearSolver(LinearSolver):
    """Adds preconditioner freeze/reuse (reference
    IterativeLinearSolver.py:79-86, consumed at PCGSolver.py:92-94)."""

    def __init__(self, control: SolverConfig,
                 precond_type: PreconditionerType):
        super().__init__()
        self.control = control
        self.precond_type = precond_type
        self._prec_frozen = False
        self._formed_prec: Optional[Preconditioner] = None
        self._tolerance_override: Optional[float] = None

    def freeze_prec(self):
        self._prec_frozen = True

    def unfreeze_prec(self):
        self._prec_frozen = False

    def prec_frozen(self) -> bool:
        return self._prec_frozen

    freezePrec = freeze_prec
    unfreezePrec = unfreeze_prec
    precFrozen = prec_frozen

    def set_tolerance(self, tau: float):
        """Reference IterativeSolver.setTolerance (IterativeSolver.py:83) —
        used by Newton's adaptive linear tolerance."""
        self._tolerance_override = float(tau)

    setTolerance = set_tolerance

    def _effective_tau(self) -> float:
        return (self._tolerance_override
                if self._tolerance_override is not None
                else self.control.tau)

    def _get_precond(self, A_host, A_dev) -> Preconditioner:
        if self._formed_prec is not None and self._prec_frozen:
            return self._formed_prec
        if isinstance(self.precond_type, IdentityPreconditionerType):
            # identity never depends on A: form once so repeat solves keep
            # hitting the same jitted computation
            if self._formed_prec is not None:
                return self._formed_prec
            prec = self.precond_type.form()
        else:
            if A_host is None:
                raise ValueError(
                    "preconditioner setup needs a HostCSR matrix; pass the "
                    "host matrix (or a (host, device) pair) to solve()")
            prec = self.precond_type.form(A_host, A_dev)
        self._formed_prec = prec
        return prec

    def _split_matrix(self, A):
        if isinstance(A, tuple):
            return A
        # freeze_matrix is the user's promise that A won't change: cache
        # the device pack so repeat solves (and benchmarks' steady-state
        # timing) don't re-pack/re-upload the operator every call
        cached = getattr(self, "_split_cache", None)
        if cached is not None and cached[0] is A and self.matrix_frozen():
            return cached[1]
        host, dev = as_device_matrix(A)
        self._split_cache = (A, (host, dev))
        return host, dev

    # --- distributed route (mesh=...) ----------------------------------
    # One-line distributed solve: shard the operator and vectors over the
    # 1-D row mesh (DIA slabs with ppermute halos for banded matrices,
    # ELL + all-gather otherwise) and run the SAME jitted solver core —
    # GSPMD inserts the psums for dots/norms.  Pair with
    # parallel.BlockJacobiILUPreconditionerType for a distributed
    # preconditioned solve (VERDICT r1 item 5).

    def _mesh_setup(self, A_host, tag: str, dtype=None):
        """Shard the operator over the mesh (cached on ``_<tag>_state``
        across solves while the matrix is frozen).  ``dtype`` casts the
        host matrix first (the mixed route's f32 copy); the (possibly
        cast) host matrix rides in the state as ``H``."""
        from .parallel import (shard_dia, shard_ell, dist_dia_spmv,
                               dist_ell_spmv, pad_vector_dia,
                               pad_vector_ell)

        attr = f"_{tag}_state"
        if self.matrix_frozen() and getattr(self, attr, None):
            return getattr(self, attr)
        H = A_host if dtype is None else HostCSR(
            A_host.indptr, A_host.indices,
            A_host.data.astype(dtype), A_host.shape)
        if DiaMatrix.is_profitable(H):
            ms = dict(H=H, A=shard_dia(H, self.mesh),
                      mv=dist_dia_spmv, pad=pad_vector_dia)
        else:
            ms = dict(H=H, A=shard_ell(H, self.mesh),
                      mv=dist_ell_spmv, pad=pad_vector_ell)
        setattr(self, attr, ms)
        return ms

    def _cached_jit(self, attr: str, key, make):
        """Per-solver jitted-callable cache: re-jit only when ``key``
        changes.  Every key must include whatever the closure captures —
        the stale-closure class of bug (a cached solve built over a DIA
        shard invoked on an ELL shard) comes from under-keyed caches."""
        if getattr(self, attr, None) is None or \
                getattr(self, attr + "_key", None) != key:
            setattr(self, attr, jax.jit(make()))
            setattr(self, attr + "_key", key)
        return getattr(self, attr)

    def _mesh_inner_jit(self, ms, tag: str, method: str, restart, orthog,
                        check_true_residual: bool = True,
                        flexible: bool = False):
        """One jitted sharded solve (cached on ``_<tag>_jit``): the SAME
        solver core as single-device, with GSPMD inserting the psums for
        the sharded dots/norms.  Forms the preconditioner from the state's
        host matrix; re-jits only when the formed preconditioner, method,
        restart, orthogonalization or operator format change."""
        from .linear.krylov import cg_solve as _cg, gmres_solve as _gm

        prec = self._get_precond(ms["H"], ms["A"])
        if getattr(self, f"_{tag}_prec_src", None) is not prec:
            setattr(self, f"_{tag}_prec_src", prec)
            papply = None if prec.is_identity else prec.apply_any
            n, n_pad = ms["H"].shape[0], ms["A"].n_pad
            if papply is not None and n_pad != n \
                    and getattr(self.precond_type, "mesh", None) is None:
                # a single-device preconditioner (AMG/GMG/ILU built on
                # the n-row host matrix) acts on the real rows; the
                # shard padding rows carry zeros through the solve
                papply = functools.partial(_apply_unpadded,
                                           prec.apply_any, n)
            setattr(self, f"_{tag}_papply", papply)
        papply = getattr(self, f"_{tag}_papply")
        control = self.control
        # ms["mv"] is the format-specific distributed SpMV (dist_dia_spmv
        # vs dist_ell_spmv, module-level functions) — keying on it keeps a
        # cached closure from running the wrong kernel when an unfrozen
        # solver is reused on a matrix of a different storage format
        key = (method, restart, orthog, flexible, check_true_residual,
               id(prec), ms["mv"], control.maxiter)

        def make():
            dist_mv = ms["mv"]

            def _solve(A_sh, bv, tau):
                mv = lambda v: dist_mv(A_sh, v)
                if method == "cg":
                    return _cg(mv, bv, maxiter=control.maxiter, tau=tau,
                               precond=papply, norm_fn=control.norm_fn())
                return _gm(mv, bv, maxiter=control.maxiter, tau=tau,
                           precond=papply, restart=restart,
                           orthog=orthog, flexible=flexible,
                           check_true_residual=check_true_residual,
                           norm_fn=control.norm_fn())

            return _solve

        return self._cached_jit(f"_{tag}_jit", key, make)

    def _solve_mesh_multi(self, A, B, method: str) -> SolveStatus:
        """Blocked multi-RHS solve over the mesh: the lockstep solvers
        (krylov.cg_solve_multi / gmres_solve_multi) run on the row-sharded
        operator with the distributed SpMV vmapped over columns — ONE
        ppermute-halo operator pass per lockstep step for all k RHS,
        GSPMD-inserted psums on the per-column dots.  Returns one
        aggregate SolveStatus (soln (n, k), max iters/resid, success only
        if every column succeeded)."""
        from .linear.krylov import (KrylovState, cg_solve_multi,
                                    gmres_solve_multi)

        A_host = A[0] if isinstance(A, tuple) else A
        if not isinstance(A_host, HostCSR):
            raise TypeError("mesh= solves take a HostCSR matrix "
                            "(row partitioning happens at setup)")
        ms = self._mesh_setup(A_host, "mesh")
        prec = self._get_precond(ms["H"], ms["A"])
        papply = (None if prec.is_identity
                  else jax.vmap(prec.apply_any, in_axes=1, out_axes=1))
        mv1, A_sh = ms["mv"], ms["A"]
        control = self.control
        key = ("multi", method, id(prec), ms["mv"], control.maxiter)

        def make():
            def run(A_sh, Bd, tau):
                mvm = jax.vmap(lambda v: mv1(A_sh, v),
                               in_axes=1, out_axes=1)
                if method == "cg":
                    return cg_solve_multi(mvm, Bd, maxiter=control.maxiter,
                                          tau=tau, precond=papply)
                return gmres_solve_multi(mvm, Bd,
                                         maxiter=control.maxiter,
                                         tau=tau, precond=papply)
            return run

        run = self._cached_jit("_mesh_multi_jit", key, make)
        n = A_host.shape[0]
        B = np.asarray(B)
        n_pad = A_sh.n_pad
        # solve in the OPERATOR dtype (the single-RHS contract): a numpy
        # f64 B must not silently promote every lockstep iteration to
        # f64 against an f32 sharded operator
        Bp = np.zeros((n_pad, B.shape[1]), dtype=ms["H"].data.dtype)
        Bp[:n] = B
        from jax.sharding import NamedSharding, PartitionSpec as PS
        from .parallel.mesh import ROW_AXIS
        Bd = jax.device_put(jnp.asarray(Bp),
                            NamedSharding(self.mesh, PS(ROW_AXIS, None)))
        X, st, _ = run(A_sh, Bd, self._effective_tau())
        worst = int(np.asarray(st.reason).max())
        agg = KrylovState(jnp.int32(int(np.asarray(st.k).max())),
                          jnp.asarray(float(np.asarray(st.resid).max())),
                          jnp.int32(worst))
        return make_status(X[:n], agg, self.control)

    def _solve_mesh(self, A, b, method: str, restart=None,
                    orthog: str = "mgs",
                    flexible: bool = False) -> SolveStatus:
        A_host = A[0] if isinstance(A, tuple) else A
        if not isinstance(A_host, HostCSR):
            raise TypeError("mesh= solves take a HostCSR matrix "
                            "(row partitioning happens at setup)")
        ms = self._mesh_setup(A_host, "mesh")
        run = self._mesh_inner_jit(ms, "mesh", method, restart, orthog,
                                   flexible=flexible)
        n = A_host.shape[0]
        b_pad = ms["pad"](ms["A"], np.asarray(b))
        x, st, hist = run(ms["A"], b_pad, self._effective_tau())
        return make_status(x[:n], st, self.control, history=hist)

    # --- distributed mixed precision (mesh= + precision="mixed") -------
    # f32 sharded inner Krylov corrections + host f64 residual
    # refinement: the sharded solve is the SAME jitted core as
    # `_solve_mesh` (GSPMD psums, halo-exchange SpMV) but on an f32 copy
    # of the operator; the outer loop recomputes exact f64 residuals on
    # the host CSR and re-dispatches scaled-to-O(1) correction solves
    # (restart-chain semantics of refine.ir_solve_host).  This is the
    # one-line distributed path to 1e-10-grade tolerances.

    def _solve_mesh_mixed(self, A, b, method: str, restart=None,
                          orthog: str = "mgs",
                          flexible: bool = False) -> SolveStatus:
        from .linear.krylov import KrylovState

        if self.control.norm != "2":
            raise ValueError(
                "precision='mixed' tests convergence in the 2-norm (the "
                "refinement machinery's scaling analysis relies on it); "
                f"norm={self.control.norm!r} is not supported there")

        A_host = A[0] if isinstance(A, tuple) else A
        if not isinstance(A_host, HostCSR):
            raise TypeError("mesh= solves take a HostCSR matrix "
                            "(row partitioning happens at setup)")
        ms = self._mesh_setup(A_host, "mm", dtype=np.float32)
        # the host loop re-measures exact f64 residuals anyway — skip
        # GMRES's in-graph true-residual recheck (an extra distributed
        # matvec per pass whose verdict would be discarded)
        run = self._mesh_inner_jit(ms, "mm", method, restart, orthog,
                                   check_true_residual=False,
                                   flexible=flexible)
        n = A_host.shape[0]

        # host-driven refinement: exact f64 residuals on the host CSR,
        # scaled O(1) f32 correction solves on the mesh
        b_h = np.asarray(b, dtype=np.float64)
        b_norm = float(np.linalg.norm(b_h))
        tol = self._effective_tau() * b_norm
        x_h = np.zeros_like(b_h)
        inner_total = 0
        rn_prev = float("inf")
        reason = StopReason.MAXITER
        rn = b_norm

        # residual-replacement fast path (krylov.cg_solve_rr over the
        # mesh): the f32 sharded recurrence is periodically replaced by
        # the true f64 residual from an f64-sharded operator copy, so
        # the WHOLE distributed solve converges like f64 CG at f32 speed
        # in one dispatch (same shard geometry for both dtypes — slab /
        # row_tile depend only on structure).  Not-converged falls
        # through to the restart-chain loop below, starting from x.
        from .linear.refine import _rr_enabled
        if method == "cg" and _rr_enabled() and b_norm > 0 \
                and jax.config.jax_enable_x64:
            from .linear.krylov import cg_solve_rr
            ms64 = self._mesh_setup(A_host, "mm64", dtype=np.float64)
            prec = getattr(self, "_mm_prec_src", None)
            papply = getattr(self, "_mm_papply", None)
            # hi matvec over the mesh when a preconditioner keeps the
            # iteration count low (same policy as ir_solve_dd): the f64
            # sharded recurrence reaches f64-CG counts and an
            # error-clean final residual direction
            hi = papply is not None
            key = ("rr", id(prec), ms["mv"], ms64["mv"],
                   self.control.maxiter, hi)

            def make():
                mv32, mv64 = ms["mv"], ms64["mv"]
                control = self.control

                def _rr(A32_sh, A64_sh, b64, tau):
                    x64, st, _ = cg_solve_rr(
                        lambda v: mv32(A32_sh, v), b64,
                        mv_hi=lambda v: mv64(A64_sh, v),
                        maxiter=control.maxiter, tau=tau, precond=papply,
                        hi_matvec=hi)
                    return x64, st.k

                return _rr

            rr_run = self._cached_jit("_mm_rr_jit", key, make)
            b_pad = ms64["pad"](ms64["A"], b_h / b_norm)
            x64, k = rr_run(ms["A"], ms64["A"], b_pad,
                            self._effective_tau())
            inner_total += int(k)
            x_h = b_norm * np.asarray(x64[:n], dtype=np.float64)
        elif method == "gmres" and b_norm > 0 \
                and jax.config.jax_enable_x64:
            # f64 FGMRES fast path over the mesh (round-3 accuracy
            # design, refine._cached_dd_chain): f64 sharded basis +
            # matvec, the f32 preconditioner riding as the flexible
            # part — f64-grade counts and error, one dispatch, no
            # restart-chain waste.  Falls through to the f32 chain
            # below if not converged.
            from .linear.krylov import gmres_solve
            ms64 = self._mesh_setup(A_host, "mm64", dtype=np.float64)
            prec = getattr(self, "_mm_prec_src", None)
            papply = getattr(self, "_mm_papply", None)
            key = ("fg64", id(prec), ms64["mv"], self.control.maxiter,
                   restart, orthog)

            def make():
                mv64 = ms64["mv"]
                control = self.control
                papply64 = (None if papply is None else
                            (lambda v: papply(
                                v.astype(jnp.float32)).astype(
                                    jnp.float64)))

                def _fg(A64_sh, b64, tau):
                    x64, st, _ = gmres_solve(
                        lambda v: mv64(A64_sh, v), b64,
                        maxiter=control.maxiter, tau=tau,
                        precond=papply64, restart=restart,
                        orthog=orthog, flexible=True,
                        check_true_residual=False)
                    return x64, st.k

                return _fg

            fg_run = self._cached_jit("_mm_fg64_jit", key, make)
            b_pad = ms64["pad"](ms64["A"], b_h / b_norm)
            x64, k = fg_run(ms64["A"], b_pad, self._effective_tau())
            inner_total += int(k)
            x_h = b_norm * np.asarray(x64[:n], dtype=np.float64)
        for disp in range(21):
            r = b_h - A_host.matvec(x_h)
            rn = float(np.linalg.norm(r))
            if rn <= tol:
                reason = StopReason.CONVERGED
                break
            if disp == 20:
                break        # 20 correction passes done; rn is current
            if rn >= rn_prev * 0.5:
                reason = (StopReason.MAXITER if rn <= b_norm * 1e-3
                          else StopReason.BREAKDOWN)
                break
            rn_prev = rn
            # close the remaining gap with f32 slack; floored at the f32
            # single-pass limit (ir_solve_host's inner_tau semantics)
            tau_k = float(np.clip(0.25 * tol / rn, 1e-6, 0.5))
            r_pad = ms["pad"](ms["A"], (r / rn).astype(np.float32))
            d, st, _ = run(ms["A"], r_pad, tau_k)
            inner_total += int(st.k)
            x_h = x_h + rn * np.asarray(d[:n], dtype=np.float64)
        return make_status(
            jnp.asarray(x_h),
            KrylovState(jnp.int32(inner_total), jnp.float64(rn),
                        jnp.int32(int(reason))),
            self.control)

    # --- mixed-precision route (precision="mixed") ---------------------
    # Inner f32 Krylov (DIA for banded stencils, ELL otherwise) + f64
    # residual refinement.  The f32 operator rides as a traced pytree
    # argument of one cached inner jit (refine._cached_inner_op), so
    # Newton steps that bump the Jacobian's values reuse the compilation.

    def _solve_mixed(self, A, b, method: str, restart=None) -> SolveStatus:
        if self.control.norm != "2":
            raise ValueError(
                "precision='mixed' tests convergence in the 2-norm (the "
                "refinement machinery's scaling analysis relies on it); "
                f"norm={self.control.norm!r} is not supported there")

        if isinstance(A, HostCSR):
            # do NOT _split_matrix a host operator here: that eagerly
            # builds a NATIVE-dtype device copy the mixed route never
            # touches (it packs its own f32 operator + f64 oracle)
            A_host, A_dev = A, None
        else:
            A_host, A_dev = self._split_matrix(A)
        if self.matrix_frozen() and getattr(self, "_mx", None) is not None:
            mx = self._mx
        else:
            if isinstance(A_dev, DiaMatrix):
                A32 = (A_dev if A_dev.dtype == jnp.float32 else DiaMatrix(
                    A_dev.diags.astype(jnp.float32), A_dev.offsets,
                    A_dev.shape))
            elif A_host is None:
                raise ValueError("mixed-precision solve needs a HostCSR "
                                 "matrix (or a DIA device matrix)")
            elif DiaMatrix.is_profitable(A_host):
                A32 = DiaMatrix.from_host_csr(A_host, dtype=np.float32)
            else:
                A32 = EllMatrix.from_host_csr(A_host, dtype=np.float32)
            Hp64 = None
            A64 = None
            if A_host is not None:
                mv_hi = A_host.matvec
                Hp32 = HostCSR(A_host.indptr, A_host.indices,
                               A_host.data.astype(np.float32), A_host.shape)
                Hp64 = A_host
            else:
                # DIA device only: true residuals from its diagonals on
                # host (at the device matrix's own precision)
                diags = np.asarray(A_dev.diags)
                offsets = A_dev.offsets
                n, m = A_dev.shape

                def mv_hi(v):
                    y = np.zeros(n, dtype=np.result_type(v, np.float64))
                    for d, off in enumerate(offsets):
                        i = np.arange(max(0, -off), min(n, m - off))
                        y[i] += diags[d, i] * v[i + off]
                    return y

                Hp32 = None
                if A_dev.dtype == jnp.float64:
                    # device f64 DIA (e.g. Newton Jacobians): the
                    # dd-chain's hi residual runs on it directly
                    A64 = A_dev
            mx = dict(A32=A32, mv_hi=mv_hi, Hp32=Hp32, Hp64=Hp64, A64=A64)
            self._mx = mx
        return self._finish_mixed(mx, b, method, restart)

    def _finish_mixed(self, mx, b, method, restart) -> SolveStatus:
        from .linear.refine import ir_solve_host
        if self._formed_prec is not None and self._prec_frozen:
            prec = self._formed_prec
        else:
            from .utils.timing import Timer
            with Timer("mixed.prec_form"):
                prec = self._get_precond(mx["Hp32"], mx["A32"])
        if getattr(self, "_mx_prec_src", None) is not prec:
            # prec.apply_right makes a FRESH bound method each access —
            # pin one so the inner-jit cache key stays stable
            self._mx_prec_src = prec
            self._mx_papply = None if prec.is_identity else prec.apply_any

        bp = np.asarray(b, dtype=np.float64)
        eff = self._effective_tau()
        inner_tau = max(min(eff, 0.5), 1e-6)
        A64 = mx.get("A64")
        if _dd_chain_enabled() and A64 is None \
                and mx.get("Hp64") is not None:
            src = mx["Hp64"]
            from .sparse.device import EllTMatrix
            A64 = (DiaMatrix.from_host_csr(src, dtype=np.float64)
                   if DiaMatrix.is_profitable(src)
                   else EllTMatrix.from_host_csr(src, dtype=np.float64))
            mx["A64"] = A64
        if _dd_chain_enabled() and A64 is not None:
            from .linear.refine import ir_solve_dd
            tr = prec.traced
            x, st, _ = ir_solve_dd(
                mx["mv_hi"], bp, A_lo=mx["A32"], A64=A64, tau=eff,
                inner_tau=inner_tau, inner_maxiter=self.control.maxiter,
                method=method, restart=restart, precond_pair=tr,
                precond_lo=None if tr is not None else self._mx_papply,
                chain=4)
        else:
            x, st, _ = ir_solve_host(
                mx["mv_hi"], None, bp, tau=eff, inner_tau=inner_tau,
                inner_maxiter=self.control.maxiter, method=method,
                restart=restart, precond_lo=self._mx_papply,
                host_residual=True, A_lo=mx["A32"],
                precond_pair=prec.traced, chain=2)
        return make_status(jnp.asarray(x), st, self.control, history=None)


# ---------------------------------------------------------------------------
# PCG
# ---------------------------------------------------------------------------

class PCG(IterativeLinearSolverType):
    """Factory for preconditioned CG (reference PCGSolver.py:25-36).

    ``precision="mixed"`` solves to f64-grade tolerances with f32 device
    kernels (host-residual refinement); ``mesh=`` runs the solve sharded
    over a 1-D device mesh (parallel/).  The two compose: ``mesh=`` +
    ``precision="mixed"`` runs f32 sharded correction solves inside a
    host f64 refinement loop (`_solve_mesh_mixed`)."""

    def make_solver(self):
        s = PCGSolver(self.control, self.precond)
        s.precision = self.precision
        s.mesh = self.mesh
        return s

    makeSolver = make_solver


def _iter_printer(control: SolverConfig, name: str):
    """Live per-iteration reporter (reference IterativeSolver.py:90-99)."""
    if not control.show_iters:
        return None
    interval = max(control.interval, 1)

    def cb(k, resid):
        k = int(k)
        if k % interval == 0:
            print(f"  {name} iter={k:6d}  ||r||={float(resid):12.5e}")

    return cb


class PCGSolver(IterativeLinearSolver):
    def __init__(self, control, precond_type):
        super().__init__(control, precond_type)
        self._jitted = None
        self._jit_prec = None
        self._jit_passable = None
        self._jit_op = None

    def solve(self, A, b) -> SolveStatus:
        if np.ndim(b) == 2:
            if getattr(self, "mesh", None) is not None \
                    and getattr(self, "precision", "native") == "native":
                # blocked lockstep CG over the mesh (one ppermute-halo
                # operator pass per step for all k RHS)
                return self._solve_mesh_multi(A, b, "cg")
            raise ValueError(
                "factory solvers take a 1-D right-hand side here; for "
                "k RHS use pysolvers_tpu.solve(A, B) (blocked multi-RHS), "
                "linear.cg_solve_multi, or mesh= with precision='native'")
        if getattr(self, "mesh", None) is not None:
            if getattr(self, "precision", "native") == "mixed":
                return self._solve_mesh_mixed(A, b, "cg")
            return self._solve_mesh(A, b, "cg")
        if getattr(self, "precision", "native") == "mixed":
            return self._solve_mixed(A, b, "cg")
        A_host, A_dev = self._split_matrix(A)
        b = jnp.asarray(b, dtype=getattr(A_dev, "dtype", None))
        prec = self._get_precond(A_host, A_dev)
        # one jitted solve per formed preconditioner; the matrix and the
        # tolerance are traced arguments, so repeated solves (e.g. Newton
        # steps with a frozen preconditioner) reuse the compilation
        # matrix-free operators can't be jit arguments; capture in closure
        passable = isinstance(A_dev, (EllMatrix, DiaMatrix, jax.Array))
        if (self._jitted is None or self._jit_prec is not prec
                or self._jit_passable != passable
                or (not passable and self._jit_op is not A_dev)):
            control = self.control
            papply = None if prec.is_identity else prec.apply_any

            if passable:
                def _solve(A_dev, b, tau):
                    return cg_solve(
                        lambda v: matvec(A_dev, v), b,
                        maxiter=control.maxiter, tau=tau, precond=papply,
                        norm_fn=control.norm_fn(),
                        iter_callback=_iter_printer(control, "PCG"))
                self._jitted = jax.jit(_solve)
            else:
                op = A_dev

                def _solve(_unused, b, tau):
                    return cg_solve(
                        lambda v: matvec(op, v), b,
                        maxiter=control.maxiter, tau=tau, precond=papply,
                        norm_fn=control.norm_fn(),
                        iter_callback=_iter_printer(control, "PCG"))
                self._jitted = _solve
            self._jit_prec = prec
            self._jit_passable = passable
            self._jit_op = A_dev
        x, st, hist = self._jitted(A_dev if passable else None, b,
                                   self._effective_tau())
        return make_status(x, st, self.control, history=hist,
                           live_reported=self.control.show_iters)


# ---------------------------------------------------------------------------
# GMRES
# ---------------------------------------------------------------------------

class GMRES(IterativeLinearSolverType):
    """Factory for right-preconditioned GMRES (reference
    GMRESSolver.py:27-40).  The reference never restarts (m = maxiter);
    ``restart`` adds GMRES(m)."""

    def __init__(self, control: Optional[SolverConfig] = None,
                 precond: Optional[PreconditionerType] = None,
                 restart: Optional[int] = None, flexible: bool = False,
                 orthog: str = "mgs", precision: str = "native", mesh=None):
        super().__init__(control, precond, precision=precision, mesh=mesh)
        self.restart = restart
        self.flexible = flexible
        self.orthog = orthog

    def make_solver(self):
        s = GMRESSolver(self.control, self.precond, self.restart,
                        self.flexible, self.orthog)
        s.precision = self.precision
        s.mesh = self.mesh
        return s

    makeSolver = make_solver


class GMRESSolver(IterativeLinearSolver):
    def __init__(self, control, precond_type, restart=None, flexible=False,
                 orthog="mgs"):
        super().__init__(control, precond_type)
        self.restart = restart
        self.flexible = flexible
        self.orthog = orthog

    def solve(self, A, b) -> SolveStatus:
        if np.ndim(b) == 2:
            if getattr(self, "mesh", None) is not None \
                    and getattr(self, "precision", "native") == "native":
                too_big = ((self.control.maxiter + 1) * np.shape(b)[0]
                           * np.shape(b)[1] * 4 > (1 << 31))
                if self.restart is not None or self.orthog != "mgs" \
                        or self.flexible or too_big:
                    # gmres_solve_multi has no restart (its basis is
                    # (maxiter+1, n, k)) and runs MGS: honor the
                    # configured options via a shared-setup column loop
                    # through the single-RHS mesh path instead of
                    # silently dropping them
                    self.freeze_matrix()
                    sts = [self._solve_mesh(A, np.asarray(b)[:, j],
                                            "gmres", restart=self.restart,
                                            orthog=self.orthog,
                                            flexible=self.flexible)
                           for j in range(np.shape(b)[1])]
                    return _aggregate_multi(sts, self.control)
                # blocked lockstep GMRES over the mesh (gmres_solve_multi)
                return self._solve_mesh_multi(A, b, "gmres")
            raise ValueError(
                "factory solvers take a 1-D right-hand side here; for "
                "k RHS use pysolvers_tpu.solve(A, B) (blocked multi-RHS), "
                "linear.gmres_solve_multi, or mesh= with "
                "precision='native'")
        if getattr(self, "mesh", None) is not None:
            if getattr(self, "precision", "native") == "mixed":
                return self._solve_mesh_mixed(A, b, "gmres",
                                              restart=self.restart or 60,
                                              orthog=self.orthog,
                                              flexible=self.flexible)
            return self._solve_mesh(A, b, "gmres", restart=self.restart,
                                    orthog=self.orthog,
                                    flexible=self.flexible)
        if getattr(self, "precision", "native") == "mixed":
            # GMRES options ride in the method string (refine._one_solve)
            m = "gmres" + (":cgs2" if self.orthog == "cgs2" else "") \
                + (":flex" if self.flexible else "")
            return self._solve_mixed(A, b, m, restart=self.restart or 60)
        A_host, A_dev = self._split_matrix(A)
        b = jnp.asarray(b, dtype=getattr(A_dev, "dtype", None))
        prec = self._get_precond(A_host, A_dev)
        passable = isinstance(A_dev, (EllMatrix, DiaMatrix, jax.Array))
        if getattr(self, "_jitted", None) is None or \
                getattr(self, "_jit_prec", None) is not prec or \
                getattr(self, "_jit_passable", None) != passable or \
                (not passable and getattr(self, "_jit_op", None) is not A_dev):
            control = self.control
            restart = self.restart
            orthog = self.orthog
            flexible = self.flexible
            # generic (side="both") = ONE apply usable either side — the
            # reference's GenericPreconditioner; GMRES uses it as a RIGHT
            # preconditioner (GMRESSolver.py:107).  Applying it on both
            # sides would double the cost and solve M⁻¹AM⁻¹ instead.
            left = None if prec.generic else prec.left
            right = prec.right

            op_capture = None if passable else A_dev

            def _solve(A_dev, b, tau):
                A_eff = A_dev if op_capture is None else op_capture
                mv = lambda v: matvec(A_eff, v)
                if left is not None:
                    # left preconditioning: solve M_L⁻¹A x = M_L⁻¹b
                    # (reference LeftPreconditioner, Preconditioner.py:39-45)
                    mv_eff = lambda v: left(mv(v))
                    b_eff = left(b)
                else:
                    mv_eff, b_eff = mv, b
                x, st, hist = gmres_solve(
                    mv_eff, b_eff, maxiter=control.maxiter, restart=restart,
                    tau=tau, precond=right, norm_fn=control.norm_fn(),
                    orthog=orthog, flexible=flexible,
                    iter_callback=_iter_printer(control, "GMRES"))
                if left is not None:
                    # report the TRUE residual of the original system
                    st = st._replace(resid=control.norm_fn()(b - mv(x)))
                return x, st, hist

            self._jitted = jax.jit(_solve) if passable else _solve
            self._jit_prec = prec
            self._jit_passable = passable
            self._jit_op = A_dev
        x, st, hist = self._jitted(A_dev if passable else None, b,
                                   self._effective_tau())
        return make_status(x, st, self.control, history=hist,
                           live_reported=self.control.show_iters)


# ---------------------------------------------------------------------------
# Direct solver (reference DefaultDirectSolver.py:23-74)
# ---------------------------------------------------------------------------

class DefaultDirect(LinearSolverType):
    def make_solver(self):
        return DefaultDirectSolver()

    makeSolver = make_solver


class DefaultDirectSolver(LinearSolver):
    """Dense on-device solve (jnp.linalg.solve → LAPACK-equivalent via XLA).

    Sparse inputs are densified: the direct solver's role in this framework
    (as in the reference's AMG coarse solve, VCycleManager.py:36) is small
    systems, where a dense factorization is the right call.  Errors are
    wrapped in a failed SolveStatus (reference DefaultDirectSolver.py:72-74).
    """

    DENSIFY_LIMIT = 20_000

    def solve(self, A, b) -> SolveStatus:
        try:
            if isinstance(A, tuple):
                A = A[0] if A[0] is not None else A[1]
            if isinstance(A, HostCSR):
                if A.shape[0] > self.DENSIFY_LIMIT:
                    raise ValueError(
                        f"direct solve of n={A.shape[0]} sparse system "
                        "exceeds densify limit; use an iterative solver")
                Ad = jnp.asarray(A.to_dense())
            elif isinstance(A, (EllMatrix, DiaMatrix)):
                if A.shape[0] > self.DENSIFY_LIMIT:
                    raise ValueError(
                        f"direct solve of n={A.shape[0]} sparse system "
                        "exceeds densify limit; use an iterative solver")
                Ad = _densify_device(A)
            else:
                Ad = jnp.asarray(A)
            b = jnp.asarray(b, dtype=Ad.dtype)
            x = jnp.linalg.solve(Ad, b)
            resid = float(jnp.linalg.norm(
                jnp.matmul(Ad, x, precision=jax.lax.Precision.HIGHEST) - b))
            st = SolveStatus(success=bool(np.isfinite(resid)), soln=x,
                             resid=resid, iters=1)
            if not st.success:
                st.reason = StopReason.BREAKDOWN
                st.msg = "non-finite residual from direct solve"
            return st
        except Exception as e:  # parity: wrap errors in failed status
            return SolveStatus(success=False, soln=None, resid=np.inf,
                               iters=0, reason=StopReason.BREAKDOWN,
                               msg=f"exception in direct solve: {e}")


def _densify_device(A):
    if isinstance(A, DiaMatrix):
        n, m = A.shape
        out = jnp.zeros((n, m), dtype=A.dtype)
        for d, off in enumerate(A.offsets):
            i = jnp.arange(max(0, -off), min(n, m - off))
            out = out.at[i, i + off].set(A.diags[d, i])
        return out
    if isinstance(A, EllMatrix):
        n = A.n_rows
        rows = jnp.repeat(jnp.arange(A.n_rows_pad), A.k)
        out = jnp.zeros((A.n_rows_pad, A.n_cols_pad), dtype=A.dtype)
        out = out.at[rows, A.cols.reshape(-1)].add(A.data.reshape(-1))
        return out[:n, : A.n_cols]
    raise TypeError(type(A))
