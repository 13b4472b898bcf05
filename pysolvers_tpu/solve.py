"""One-call convenience front end: ``pysolvers_tpu.solve(A, b)``.

Picks a sensible method and preconditioner from the matrix's structure —
the "just solve it" entry point layered over the factory API (which remains
the full-control surface).  Heuristics:

* symmetric (within tolerance) → PCG, else GMRES;
* small systems (n <= 500) → direct dense solve;
* preconditioner "auto": AMG for large SPD systems, IC(t) for medium SPD,
  ILUT for nonsymmetric, none for tiny systems.

``precision="mixed"`` routes through the SAME factory machinery as
``PCG/GMRES(..., precision="mixed")`` (api._solve_mixed — dd-chain
refinement, fused one-dispatch setup); a small cache keyed on the matrix
identity AND a fingerprint of its values keeps the packed operator and
formed preconditioner across repeat solves without ever serving a stale
operator after in-place value updates.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .api import CommonSolverArgs, DefaultDirect, GMRES, PCG
from .core import SolveStatus
from .linear.amg import AMGPreconditionerType
from .linear.ilu import ICPreconditionerType, ILUTPreconditionerType
from .sparse.host import HostCSR


def _is_symmetric(A: HostCSR, rtol: float = 1e-10) -> bool:
    At = A.transpose()
    if A.nnz != At.nnz:
        return False
    if not (np.array_equal(A.indptr, At.indptr)
            and np.array_equal(A.indices, At.indices)):
        return False
    denom = np.abs(A.data).max() if A.nnz else 1.0
    return float(np.abs(A.data - At.data).max()) <= rtol * max(denom, 1e-300)


_PRECONDS = ("auto", "none", "ic", "ilut", "amg", "jacobi")


def _precond_type(precond: str, method: str, n: int):
    """Resolve a precond name to a PreconditionerType (or None).  Unknown
    names raise — a typo must not silently run unpreconditioned."""
    if precond not in _PRECONDS:
        raise ValueError(f"unknown precond {precond!r}; "
                         f"expected one of {_PRECONDS}")
    if precond == "auto":
        if method == "cg":
            precond = "amg" if n >= 20_000 else "ic"
        else:
            precond = "ilut"
    if precond == "none":
        return None
    if precond == "ic":
        return ICPreconditionerType()
    if precond == "ilut":
        return ILUTPreconditionerType()
    if precond == "amg":
        return AMGPreconditionerType(num_iters=2, num_levels=2)
    from .linear.preconditioner import JacobiPreconditionerType
    return JacobiPreconditionerType()


def solve(A, b, *, tau: float = 1e-8, maxiter: int = 1000,
          method: str = "auto", precond: str = "auto",
          precision: str = "native", detect_blocks: bool = True,
          **solver_kwargs) -> SolveStatus:
    """Solve A x = b.  Returns a SolveStatus.

    ``b`` may be (n,) or (n, k) — a 2-D right-hand side solves all k
    columns (blocked lockstep CG for native-precision SPD systems, a
    shared-setup column loop otherwise); ``soln`` is then (n, k).

    ``method``: "auto" | "cg" | "gmres" | "direct".
    ``precond``: "auto" | "none" | "ic" | "ilut" | "amg" | "jacobi".
    ``precision``: "native" solves in the matrix dtype; "mixed" runs the
    inner Krylov in f32 on the device kernels with f64 residual
    refinement — the f32 route to 1e-10 accuracy.
    ``detect_blocks``: on an all-"auto" CG call over a large HostCSR
    with detectable b×b block structure (constant partition, dense
    blocks — ``sparse.bdia.detect_block_size``), convert to BdiaMatrix
    and ride the planar block SpMV/SpMM instead of the scalar route.  Pass False to force scalar.
    Extra kwargs are forwarded to the solver factory.
    """
    if isinstance(A, np.ndarray) and A.ndim == 2:
        A = HostCSR.from_dense(A)
    from .sparse.bdia import BdiaMatrix
    if isinstance(A, BdiaMatrix):
        # block-structured (BSR-class) operator: a first-class solver
        # citizen — block preconditioners (planar-native), mixed
        # precision, multi-RHS (bdia_spmm lockstep) and mesh= sharding
        # all ride the planar shift-and-FMA SpMV.  It works in
        # PLANAR (dof-major) ordering — b/x reorder once at the solve
        # boundary (sparse/bdia.py module docstring).
        if precision not in ("native", "mixed"):
            raise ValueError(f"precision must be 'native' or 'mixed', "
                             f"got {precision!r}")
        return _solve_bdia(A, b, tau=tau, maxiter=maxiter, method=method,
                           precond=precond, precision=precision,
                           **solver_kwargs)
    if not isinstance(A, HostCSR):
        raise TypeError("solve() takes a HostCSR, dense ndarray or "
                        "BdiaMatrix; use the factory API for other device "
                        "formats / operators")
    n = A.shape[0]
    b = np.asarray(b)

    if precision not in ("native", "mixed"):
        raise ValueError(f"precision must be 'native' or 'mixed', "
                         f"got {precision!r}")
    if method == "auto":
        if n <= 500:
            method = "direct"
        else:
            method = "cg" if _is_symmetric(A) else "gmres"

    if (detect_blocks and method == "cg" and precond == "auto"
            and n >= 10_000 and "mesh" not in solver_kwargs):
        # VERDICT r4 item 8: CSR holders whose matrix is b×b
        # block-structured reach the BDIA lane (planar SpMV/SpMM)
        # without hand-building a BdiaMatrix.  The layout
        # plan is structure-cached (sparse/bdia._BDIA_PLAN_CACHE), so
        # repeat solves pay only the value scatter.
        from .sparse.bdia import BdiaMatrix, detect_block_size
        bsz = detect_block_size(A)
        if bsz is not None:
            return _solve_bdia(BdiaMatrix.from_host_csr(A, bsz), b,
                               tau=tau, maxiter=maxiter, method="cg",
                               precond="auto", precision=precision,
                               **solver_kwargs)

    if b.ndim == 2:
        if b.shape[1] == 0:
            raise ValueError("solve(A, B): B has zero columns")
        return _solve_multi(A, b, tau=tau, maxiter=maxiter, method=method,
                            precond=precond, precision=precision,
                            **solver_kwargs)
    if b.ndim != 1:
        raise ValueError(f"solve() takes b of shape (n,) or (n, k); "
                         f"got {b.shape}")

    if method == "direct":
        return DefaultDirect().make_solver().solve(A, b)
    if method not in ("cg", "gmres"):
        raise ValueError(f"unknown method {method!r}")

    prec_type = _precond_type(precond, method, n)
    gm_kwargs = {k: v for k, v in solver_kwargs.items()
                 if k in ("restart", "flexible", "orthog")}

    if precision == "mixed":
        return _cached_mixed_solver(
            A, method, precond, tau, maxiter,
            gm_kwargs.get("restart"), prec_type).solve(A, b)

    control = CommonSolverArgs(maxiter=maxiter, tau=tau)
    if method == "cg":
        factory = PCG(control, precond=prec_type)
    else:
        factory = GMRES(control, precond=prec_type, **gm_kwargs)
    return factory.make_solver().solve(A, b)


_BDIA_PRECONDS = ("auto", "none", "bjacobi", "bcheb", "bmg", "ic")

# repeat-solve cache for BDIA operators: dtype casts and formed
# preconditioners keyed on the planes array's identity (jax arrays are
# immutable, and the entry holds a strong reference, so an id can never
# be serving a different array).  Without this every solve() re-paid the
# astype AND the full preconditioner setup — for 'bmg' that is b SA
# hierarchy builds, far more host time than the solve itself.
_BDIA_SOLVE_CACHE: dict = {}


def _bdia_cache_entry(A) -> dict:
    key = id(A.planes)
    ent = _BDIA_SOLVE_CACHE.get(key)
    if ent is None or ent["planes"] is not A.planes:
        if len(_BDIA_SOLVE_CACHE) > 8:
            _BDIA_SOLVE_CACHE.pop(next(iter(_BDIA_SOLVE_CACHE)))
        ent = {"planes": A.planes}
        _BDIA_SOLVE_CACHE[key] = ent
    return ent


def _bdia_cast(A, dtype_name: str):
    """astype with identity caching (dtype_name: 'f32' | 'f64')."""
    import jax.numpy as jnp
    dt = jnp.float32 if dtype_name == "f32" else jnp.float64
    if A.dtype == dt:
        return A
    ent = _bdia_cache_entry(A)
    got = ent.get(dtype_name)
    if got is None:
        got = ent[dtype_name] = A.astype(dt)
    return got


def _bdia_precond(A, precond: str):
    """(apply, traced_pair) planar preconditioner for a BdiaMatrix.
    Formed preconditioners are identity-cached on (planes, name)."""
    if precond not in _BDIA_PRECONDS:
        raise ValueError(f"unknown BDIA precond {precond!r}; expected "
                         f"one of {_BDIA_PRECONDS}")
    if precond == "auto":
        precond = "bjacobi"
    if precond == "none":
        return None, None
    ent = _bdia_cache_entry(A)
    got = ent.get(("prec", precond))
    if got is not None:
        return got
    got = _bdia_precond_form(A, precond)
    ent[("prec", precond)] = got
    return got


def _bdia_precond_form(A, precond: str):
    if precond == "bjacobi":
        from .linear.block_precond import BlockJacobiBdiaPreconditionerType
        prec = BlockJacobiBdiaPreconditionerType().form(A_dev=A)
        return prec.apply_any, prec.traced
    if precond == "bcheb":
        from .linear.block_precond import (
            BlockChebyshevBdiaPreconditionerType)
        prec = BlockChebyshevBdiaPreconditionerType().form(A_dev=A)
        return prec.apply_any, None
    if precond == "bmg":
        # STRONG planar option: dof-decoupled multigrid, zero per-apply
        # transposes (block_precond.BlockMGBdiaPreconditionerType)
        from .linear.block_precond import BlockMGBdiaPreconditionerType
        prec = BlockMGBdiaPreconditionerType().form(A_dev=A)
        return prec.apply_any, prec.traced
    # scalar IC(t) via the host CSR view: factor in node-major order,
    # apply with planar<->node transposes per application — the parity
    # option (a full-vector transpose costs ~8x on a bandwidth-bound
    # kernel; prefer 'bjacobi'/'bcheb' for speed)
    from .linear.ilu import ICPreconditionerType
    H = A.to_host_csr()
    H32 = HostCSR(H.indptr, H.indices, H.data.astype(np.float32), H.shape)
    inner = ICPreconditionerType().form(H32)

    def apply(v):
        vn = A.from_planar(v)
        return A.to_planar(inner.apply_any(vn).astype(v.dtype))

    return apply, None


def _solve_bdia(A, b, *, tau, maxiter, method, precond="auto",
                precision="native", mesh=None, **solver_kwargs):
    """solve() route for a BdiaMatrix operator: natural-ordered b in,
    natural-ordered solution out; the lockstep/blocked kernels run in
    the format's planar ordering in between.

    ``precond``: "auto" (= block-Jacobi) | "none" | "bjacobi" | "bcheb"
    (block-Chebyshev) | "ic" (scalar IC via the host CSR view).
    ``precision="mixed"`` runs the f64-residual dd-chain with the f32
    planar kernel inside (refine.ir_solve_dd — the same machinery as the
    HostCSR route).  ``mesh``: 1-D jax Mesh — planes and vectors shard
    over the block-row axis with ppermute halos (parallel/bdia.py).
    """
    import jax.numpy as jnp

    from .core import StopReason, make_status
    from .linear.krylov import cg_solve, cg_solve_multi, gmres_solve
    from .ops import matmat as op_matmat, matvec as op_matvec
    from .sparse.bdia import BdiaMatrix

    if method in ("auto", "direct"):
        method = "cg"            # BDIA problems are large by construction
    if method not in ("cg", "gmres"):
        raise ValueError(f"unknown method {method!r} for BdiaMatrix")
    control = CommonSolverArgs(maxiter=maxiter, tau=tau)

    if mesh is not None:
        return _solve_bdia_mesh(A, b, tau=tau, maxiter=maxiter,
                                method=method, precond=precond,
                                precision=precision, mesh=mesh,
                                control=control)

    b_np = np.asarray(b)
    multi = b_np.ndim == 2

    if precision == "mixed":
        if multi:
            # blocked lockstep refinement: f64 residual block and f32
            # lockstep corrections on the planar row layout — no column
            # loop
            return _solve_bdia_multi_mixed(A, b_np, tau=tau,
                                           maxiter=maxiter,
                                           precond=precond,
                                           control=control)
        from .linear.refine import ir_solve_dd
        A32 = _bdia_cast(A, "f32")
        A64 = _bdia_cast(A, "f64")
        papply, traced = _bdia_precond(A32, precond)
        # planar reorder on host (numpy): keeps f64 exact regardless of
        # the x64 flag and avoids a device round trip
        bp = np.asarray(b_np, dtype=np.float64).reshape(
            A.nb, A.b).T.reshape(-1)
        # block-Jacobi/Chebyshev are WEAK (long recurrences) and SPD:
        # the f64 recurrence matvec and the short replacement cadence
        # that pay off for strong factorizations would spend most of the
        # solve in f64 BDIA applies.  Scalar IC keeps the strong-
        # preconditioner auto behavior.
        weak = precond in ("auto", "bjacobi", "bcheb", "none")
        # 'bmg' is strong (O(10) iterations) but its iterations are
        # CHEAP (one f32 pass + b scalar V-cycles) — the f64
        # recurrence matvec the auto strong config buys
        # costs more than the extra iterations it saves; the drop-
        # triggered f32 recurrence + frequent replacement handles
        # strong-preconditioner drift (cg_solve_rr docstring, DH-11+IC)
        hi_mv = False if (weak or precond == "bmg") else None
        x, st, _ = ir_solve_dd(
            A64.host_matvec_planar, bp, A_lo=A32, A64=A64, tau=tau,
            inner_tau=max(min(tau, 0.5), 1e-6), inner_maxiter=maxiter,
            method=method, restart=solver_kwargs.get("restart"),
            precond_pair=traced,
            precond_lo=None if traced is not None else papply,
            hi_matvec=hi_mv,
            replace_every=48 if weak else None)
        return make_status(A.from_planar(x), st, control, history=None)

    if multi:
        import jax

        from .linear.krylov import KrylovState, cg_solve_multi_rows
        from .ops.spmv import bdia_spmm_rows

        # ROW layout (k, n_planar): one RHS per row, one planar SpMM
        # pass per lockstep step for all k
        k = b_np.shape[1]
        Bp_rows = jnp.asarray(
            b_np.T.reshape(k, A.nb, A.b).transpose(0, 2, 1)
            .reshape(k, A.b * A.nb), dtype=A.dtype)
        papply, _ = _bdia_precond(A, precond)
        pmulti = (None if papply is None
                  else jax.vmap(papply, in_axes=0, out_axes=0))
        X, st, hist = cg_solve_multi_rows(
            lambda V: bdia_spmm_rows(A, V), Bp_rows, maxiter=maxiter,
            tau=tau, precond=pmulti)
        worst = int(np.asarray(st.reason).max())
        st = KrylovState(jnp.int32(int(np.asarray(st.k).max())),
                         jnp.asarray(float(np.asarray(st.resid).max())),
                         jnp.int32(worst))
        # (k, b·nb) rows -> natural (n, k)
        Xn = jnp.transpose(
            X.reshape(k, A.b, A.nb), (2, 1, 0)).reshape(A.nb * A.b, k)
        return make_status(Xn, st, control, history=hist)
    papply, _ = _bdia_precond(A, precond)
    bp = A.to_planar(jnp.asarray(b_np, dtype=A.dtype))
    if method == "cg":
        x, st, hist = cg_solve(lambda v: op_matvec(A, v), bp,
                               maxiter=maxiter, tau=tau, precond=papply)
    else:
        x, st, hist = gmres_solve(lambda v: op_matvec(A, v), bp,
                                  maxiter=maxiter, tau=tau,
                                  precond=papply,
                                  restart=solver_kwargs.get("restart"))
    return make_status(A.from_planar(x), st, control, history=hist)


def _solve_bdia_multi_mixed(A, B_np, *, tau, maxiter, precond, control):
    """Blocked mixed multi-RHS on a BdiaMatrix, in the planar ROW layout
    (k, n).  CG with block-Jacobi (or none) runs ONE continuous lockstep
    pass with per-column f64 residual replacement (krylov.cg_lockstep_rr
    — an outer-restart composition re-spends ~2x the Krylov iterations
    rebuilding search spaces); other preconditioners run lockstep f32
    inners under per-column blocked refinement (refine.ir_solve_multi).
    Either way one planar SpMM pass per step serves all k columns."""
    import jax
    import jax.numpy as jnp

    from .core import make_status
    from .linear.krylov import (KrylovState, cg_lockstep_rr,
                                cg_solve_multi_rows)
    from .linear.refine import ir_solve_multi
    from .ops.spmv import bdia_spmm_rows

    if not jax.config.jax_enable_x64:
        # the blocked route's true-residual oracle runs IN-GRAPH in f64;
        # with x64 off jnp would silently truncate it to f32 and the
        # refinement would stall at ~1e-7 claiming convergence
        raise ValueError(
            "solve(BdiaMatrix, B, precision='mixed') needs "
            "jax.config.update('jax_enable_x64', True) — the blocked "
            "f64 residual oracle is device-resident (single-RHS mixed "
            "solves use a host-numpy oracle and work without x64)")

    k = B_np.shape[1]
    A32 = _bdia_cast(A, "f32")
    A64 = _bdia_cast(A, "f64")
    # natural (n, k) -> planar rows (k, n) in f64 (numpy: exact
    # regardless of the x64 flag)
    B_rows = jnp.asarray(np.ascontiguousarray(
        np.asarray(B_np, dtype=np.float64).T
        .reshape(k, A.nb, A.b).transpose(0, 2, 1).reshape(k, A.b * A.nb)))

    # operator tables ride through jit as TRACED arguments, not
    # closed-over constants (refine.ir_solve_multi docstring)
    if precond in ("auto", "none", "bjacobi"):
        M = None
        if precond != "none":
            from .linear.block_precond import block_jacobi_bdia_matrix
            M = block_jacobi_bdia_matrix(A32)

        @jax.jit
        def run_rr(A32, A64, M, B_rows64):
            X, st, _ = cg_lockstep_rr(
                lambda V: bdia_spmm_rows(A32, V), B_rows64,
                mm_hi=lambda V: bdia_spmm_rows(A64, V),
                maxiter=maxiter, tau=tau,
                precond=(None if M is None
                         else (lambda V: bdia_spmm_rows(M, V))),
                replace_every=48,
                dot=lambda a, c: jnp.sum(a * c, axis=1),
                bc=lambda s: s[:, None], n_rhs=k)
            return X, st

        X, st = run_rr(A32, A64, M, B_rows)
    else:
        papply, _ = _bdia_precond(A32, precond)
        pmulti = (None if papply is None
                  else jax.vmap(papply, in_axes=0, out_axes=0))

        def inner_solve(iops, R32, tau32):
            D, st, _ = cg_solve_multi_rows(
                lambda V: bdia_spmm_rows(iops[0], V), R32,
                maxiter=maxiter, tau=tau32, precond=pmulti)
            return D, st.k

        X, st, _ = ir_solve_multi(
            (lambda Ah, X: bdia_spmm_rows(Ah, X), A64), B_rows,
            inner_solve=inner_solve, inner_ops=(A32, None),
            col_norm=lambda V: jnp.sqrt(jnp.sum(V * V, axis=1)),
            bc=lambda s: s[:, None],
            tau=tau, inner_tau=max(min(tau, 0.5), 1e-6))
    worst = int(np.asarray(st.reason).max())
    agg = KrylovState(jnp.int32(int(np.asarray(st.k).max())),
                      jnp.asarray(float(np.asarray(st.resid).max())),
                      jnp.int32(worst))
    # (k, b·nb) planar rows -> natural (n, k)
    Xn = jnp.transpose(
        X.reshape(k, A.b, A.nb), (2, 1, 0)).reshape(A.nb * A.b, k)
    return make_status(Xn, agg, control)


def _solve_bdia_mesh(A, b, *, tau, maxiter, method, precond, precision,
                     mesh, control):
    """Distributed BDIA solve: planes sharded on the block-row axis,
    2-D planar vectors, ppermute halos (parallel/bdia.py).  precision=
    "mixed" runs residual-replacement CG with both operand precisions
    sharded (dots psum under jit)."""
    import jax
    import jax.numpy as jnp

    from .core import make_status
    from .linear.krylov import cg_solve, cg_solve_rr, gmres_solve
    from .parallel.bdia import (block_jacobi_sharded, dist_bdia_spmv,
                                shard_bdia)

    if precond not in ("auto", "none", "bjacobi"):
        raise ValueError("mesh= BDIA solves support precond='bjacobi' "
                         "(block-diagonal => shard-local) or 'none'")
    b_np = np.asarray(b)
    if b_np.ndim != 1:
        raise ValueError("mesh= BDIA solves take a single RHS")

    if precision == "mixed":
        A32 = _bdia_cast(A, "f32")
        A64 = _bdia_cast(A, "f64")
        S32, S64 = shard_bdia(A32, mesh), shard_bdia(A64, mesh)
        papply = None
        if precond != "none":
            apply, state = block_jacobi_sharded(S32)
            papply = lambda v: apply(state, v)   # noqa: E731
        bp = S64.to_planar(b_np.astype(np.float64))
        if method != "cg":
            raise ValueError("mesh= mixed BDIA solves run CG (rr); use "
                             "precision='native' for GMRES")
        solve = jax.jit(lambda b64: cg_solve_rr(
            lambda v: dist_bdia_spmv(S32, v.astype(jnp.float32)
                                     ).astype(jnp.float64),
            b64, mv_hi=lambda v: dist_bdia_spmv(S64, v),
            maxiter=maxiter, tau=tau, precond=papply, hi_matvec=True))
        x, st, _ = solve(bp)
        return make_status(S64.from_planar(x), st, control, history=None)

    S = shard_bdia(A, mesh)
    papply = None
    if precond != "none":
        apply, state = block_jacobi_sharded(S)
        papply = lambda v: apply(state, v)       # noqa: E731
    bp = S.to_planar(b_np)
    if method == "cg":
        solve = jax.jit(lambda bv: cg_solve(
            lambda v: dist_bdia_spmv(S, v), bv, maxiter=maxiter, tau=tau,
            precond=papply))
    else:
        solve = jax.jit(lambda bv: gmres_solve(
            lambda v: dist_bdia_spmv(S, v), bv, maxiter=maxiter, tau=tau,
            precond=papply))
    x, st, hist = solve(bp)
    return make_status(S.from_planar(x), st, control, history=hist)


def _solve_multi(A: HostCSR, B: np.ndarray, *, tau, maxiter, method,
                 precond, precision, **solver_kwargs) -> SolveStatus:
    """Multi-RHS dispatch for ``solve(A, B)`` with B of shape (n, k).

    Native-precision CG runs the blocked lockstep solver
    (``linear.krylov.cg_solve_multi`` — one SpMM operator pass per
    iteration for all columns); everything else (direct, GMRES, mixed
    precision) solves column-by-column through ONE solver with the
    matrix frozen, so setup (factorization, packs, compiled graphs) is
    paid once.  Returns a single SolveStatus: ``soln`` is (n, k),
    ``iters`` the max per-column count, ``resid`` the max per-column
    residual norm, ``success`` only if every column succeeded.
    """
    import jax.numpy as jnp

    from .core import StopReason, make_status

    if method in ("cg", "gmres") and precision == "mixed":
        return _solve_multi_mixed(A, B, tau=tau, maxiter=maxiter,
                                  method=method, precond=precond,
                                  **solver_kwargs)

    if method in ("cg", "gmres") and precision == "native":
        import jax

        from .api import as_device_matrix
        from .linear.krylov import (KrylovState, cg_solve_multi,
                                    gmres_solve_multi)
        from .ops import matmat

        A_host, A_dev = as_device_matrix(A)
        prec_type = _precond_type(precond, method, A.shape[0])
        papply = None
        if prec_type is not None:
            prec = prec_type.form(A_host, A_dev)
            if not prec.is_identity:
                col_apply = prec.apply_any
                papply = jax.vmap(col_apply, in_axes=1, out_axes=1)
        # solve in the MATRIX dtype (the single-RHS route's contract,
        # api.py PCGSolver.solve) — a numpy-f64 B must not silently
        # promote the whole lockstep solve to f64
        Bd = jnp.asarray(B, dtype=getattr(A_dev, "dtype", None))
        if method == "cg":
            X, st, _ = cg_solve_multi(
                lambda V: matmat(A_dev, V), Bd, maxiter=maxiter,
                tau=tau, precond=papply)
        else:
            # gmres_solve_multi runs restarts in lockstep (per-column
            # residual carry, shared basis reset, true-residual verify
            # at cycle boundaries).  The column loop remains only for
            # orthog/flexible requests and for unrestarted basis buffers
            # that would not fit
            restart = solver_kwargs.get("restart")
            mlen = (maxiter if restart is None
                    else max(1, min(int(restart), maxiter)))
            basis_bytes = ((mlen + 1) * Bd.shape[0] * Bd.shape[1]
                           * Bd.dtype.itemsize)
            opts_used = any(k in solver_kwargs
                            for k in ("orthog", "flexible"))
            if opts_used or basis_bytes > (1 << 31):
                return _solve_multi_column_loop(
                    A, B, tau=tau, maxiter=maxiter, method=method,
                    precond=precond, precision=precision,
                    **solver_kwargs)
            X, st, _ = gmres_solve_multi(
                lambda V: matmat(A_dev, V), Bd, maxiter=maxiter,
                tau=tau, precond=papply, restart=restart)
        worst = int(np.asarray(st.reason).max())  # RUNNING<CONV<others
        agg = KrylovState(jnp.int32(int(np.asarray(st.k).max())),
                          jnp.asarray(float(np.asarray(st.resid).max())),
                          jnp.int32(worst))
        control = CommonSolverArgs(maxiter=maxiter, tau=tau)
        return make_status(X, agg, control)

    return _solve_multi_column_loop(A, B, tau=tau, maxiter=maxiter,
                                    method=method, precond=precond,
                                    precision=precision, **solver_kwargs)


def _solve_multi_mixed(A: HostCSR, B: np.ndarray, *, tau, maxiter,
                       method, precond, **solver_kwargs) -> SolveStatus:
    """Blocked mixed-precision multi-RHS (VERDICT r4 item 2): f64-grade
    accuracy AND the k× SpMM amortization in one dispatch, no column
    loop.  CG runs ONE continuous lockstep pass with per-column f64
    residual replacement (krylov.cg_lockstep_rr, columns layout);
    GMRES runs lockstep inners under per-column blocked refinement
    (refine.ir_solve_multi).  Per-column semantics match the single-RHS
    mixed route (reference bar: per-column PCG, PCGSolver.py:109-138).
    """
    import jax
    import jax.numpy as jnp

    from .api import as_device_matrix
    from .core import make_status
    from .linear.krylov import gmres_solve_multi
    from .linear.refine import ir_solve_multi
    from .ops import matmat

    if not jax.config.jax_enable_x64:
        raise ValueError(
            "solve(A, B, precision='mixed') needs "
            "jax.config.update('jax_enable_x64', True) — the blocked "
            "f64 residual oracle is device-resident (single-RHS mixed "
            "solves use a host-numpy oracle and work without x64)")
    A32_h = HostCSR(A.indptr, A.indices, A.data.astype(np.float32),
                    A.shape)
    A64_h = HostCSR(A.indptr, A.indices, A.data.astype(np.float64),
                    A.shape)
    _, A32 = as_device_matrix(A32_h, dtype=np.float32)
    _, A64 = as_device_matrix(A64_h, dtype=np.float64)

    prec_type = _precond_type(precond, method, A.shape[0])
    papply = None
    if prec_type is not None:
        prec = prec_type.form(A32_h, A32)
        if not prec.is_identity:
            papply = jax.vmap(prec.apply_any, in_axes=1, out_axes=1)

    restart = solver_kwargs.get("restart")

    B64 = jnp.asarray(np.asarray(B, dtype=np.float64))
    if method == "cg":
        # ONE continuous lockstep pass with per-column f64 residual
        # replacement (krylov.cg_lockstep_rr, columns layout) — the
        # outer-restart composition re-spends ~2x the iterations
        # rebuilding search spaces (see _solve_bdia_multi_mixed)
        from .linear.krylov import cg_lockstep_rr

        @jax.jit
        def run_rr(A32, A64, B64):
            X, st, _ = cg_lockstep_rr(
                lambda V: matmat(A32, V), B64,
                mm_hi=lambda V: matmat(A64, V),
                maxiter=maxiter, tau=tau, precond=papply,
                replace_every=48,
                dot=lambda a, c: jnp.sum(a * c, axis=0),
                bc=lambda s: s[None, :], n_rhs=B64.shape[1])
            return X, st

        X, st = run_rr(A32, A64, B64)
    else:
        def inner_solve(Ai, R32, tau32):
            D, st, _ = gmres_solve_multi(lambda V: matmat(Ai, V), R32,
                                         maxiter=maxiter, tau=tau32,
                                         precond=papply,
                                         restart=restart)
            return D, st.k

        # operators as traced jit args, not closure constants (refine.
        # ir_solve_multi docstring)
        X, st, _ = ir_solve_multi(
            (lambda Ah, X: matmat(Ah, X), A64), B64,
            inner_solve=inner_solve, inner_ops=A32,
            col_norm=lambda V: jnp.sqrt(jnp.sum(V * V, axis=0)),
            bc=lambda s: s[None, :],
            tau=tau, inner_tau=max(min(tau, 0.5), 1e-6))
    from .linear.krylov import KrylovState
    worst = int(np.asarray(st.reason).max())
    agg = KrylovState(jnp.int32(int(np.asarray(st.k).max())),
                      jnp.asarray(float(np.asarray(st.resid).max())),
                      jnp.int32(worst))
    control = CommonSolverArgs(maxiter=maxiter, tau=tau)
    return make_status(X, agg, control)


def _solve_multi_column_loop(A, B, *, tau, maxiter, method, precond,
                             precision, **solver_kwargs):
    # column loop sharing ONE solver: matrix + preconditioner frozen, so
    # setup (factorization, packs, compiled graphs) is paid once, not k×
    import jax.numpy as jnp

    from .core import StopReason

    if method == "direct":
        s = DefaultDirect().make_solver()
    elif precision == "mixed":
        s = _cached_mixed_solver(
            A, method, precond, tau, maxiter,
            solver_kwargs.get("restart"),
            _precond_type(precond, method, A.shape[0]))
    else:
        control = CommonSolverArgs(maxiter=maxiter, tau=tau)
        prec_type = _precond_type(precond, method, A.shape[0])
        gm_kwargs = {k: v for k, v in solver_kwargs.items()
                     if k in ("restart", "flexible", "orthog")}
        factory = (PCG(control, precond=prec_type) if method == "cg"
                   else GMRES(control, precond=prec_type, **gm_kwargs))
        s = factory.make_solver()
        s.freeze_matrix()
        s.freeze_prec()
    sts = [s.solve(A, B[:, j]) for j in range(B.shape[1])]
    X = jnp.stack([jnp.asarray(st.soln) for st in sts], axis=1)
    failed = [st for st in sts if not st.success]
    return SolveStatus(
        success=not failed, soln=X,
        resid=max(float(st.resid) for st in sts),
        iters=max(int(st.iters) for st in sts),
        reason=failed[0].reason if failed else StopReason.CONVERGED,
        msg="; ".join(sorted({st.msg for st in sts if st.msg})))


# --- mixed-precision solver cache ------------------------------------------
# The factory's mixed route caches packed operators / formed
# preconditioners / compiled inner graphs on the SOLVER object while the
# matrix is frozen; this front end keeps solvers across calls so repeat
# solves of the same system don't re-pack.  The key carries a fingerprint
# of the value array: mutating A.data in place and re-solving must rebuild
# (identity alone would serve the OLD operator and report convergence
# against a system the caller no longer has).
_MIXED_CACHE: dict = {}


def _cached_mixed_solver(A: HostCSR, method: str, precond: str,
                         tau: float, maxiter: int, restart,
                         prec_type):
    fp = hash(A.data.tobytes())
    key = (id(A), fp, method, precond, tau, maxiter, restart)
    ent = _MIXED_CACHE.get(key)
    if ent is not None and ent[0] is A:
        return ent[1]
    control = CommonSolverArgs(maxiter=maxiter, tau=tau)
    if method == "cg":
        factory = PCG(control, precond=prec_type, precision="mixed")
    else:
        factory = GMRES(control, precond=prec_type, precision="mixed",
                        restart=restart)
    s = factory.make_solver()
    # matrix state may be cached across solves — the value fingerprint in
    # the key is what makes this safe
    s.freeze_matrix()
    if len(_MIXED_CACHE) > 8:
        _MIXED_CACHE.pop(next(iter(_MIXED_CACHE)))
    _MIXED_CACHE[key] = (A, s)
    return s
