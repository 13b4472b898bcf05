"""Mixed-precision iterative refinement.

f32 operators move half the bytes of f64 ones in a bandwidth-bound solve,
but the reference's acceptance bar is 1e-10 relative residuals.  The
classical answer is iterative refinement: inner Krylov solves run in f32 on the fast
kernels; an outer loop accumulates the solution and recomputes the true
residual in f64.  Converges to f64-level residuals as long as the inner
solve reduces the error by a fixed factor (inner_tau ≈ 1e-6 per pass).

Fully jitted: outer ``lax.while_loop`` over inner ``cg_solve``/``gmres_solve``
calls — one compiled computation end to end.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import StopReason
from .krylov import KrylovState, cg_solve, gmres_solve, richardson_solve


class _IRCarry(NamedTuple):
    k: jax.Array
    x: jax.Array          # f64 accumulated solution
    resid: jax.Array
    inner_total: jax.Array
    reason: jax.Array


def ir_solve(matvec_hi: Callable, matvec_lo: Callable, b: jax.Array,
             *, tau: float = 1e-10, max_outer: int = 20,
             inner_tau: float = 1e-6, inner_maxiter: int = 500,
             method: str = "cg", precond_lo: Optional[Callable] = None,
             restart: Optional[int] = None):
    """Solve A x = b to f64 tolerance with f32 inner solves.

    matvec_hi: f64 SpMV (true residuals); matvec_lo: f32 SpMV (inner).
    Returns (x_f64, KrylovState, resid_history) like the Krylov drivers.
    """
    b = b.astype(jnp.float64)
    norm = lambda v: jnp.sqrt(jnp.sum(v * v))
    b_norm = norm(b)
    tol = tau * b_norm

    def inner(r32):
        if method == "cg":
            d, st, _ = cg_solve(matvec_lo, r32, maxiter=inner_maxiter,
                                tau=inner_tau, precond=precond_lo)
        elif method == "richardson":
            d, st, _ = richardson_solve(matvec_lo, r32,
                                        maxiter=inner_maxiter,
                                        tau=inner_tau, precond=precond_lo)
        else:
            d, st, _ = gmres_solve(matvec_lo, r32, maxiter=inner_maxiter,
                                   tau=inner_tau, precond=precond_lo,
                                   restart=restart,
                                   check_true_residual=False)
        return d, st

    def cond(c: _IRCarry):
        return c.reason == StopReason.RUNNING

    def body(c: _IRCarry):
        r = b - matvec_hi(c.x)
        rn = norm(r)
        # scale the correction problem to O(1) so f32 dynamic range is safe
        scale = jnp.where(rn > 0, rn, 1.0)
        d32, st = inner((r / scale).astype(jnp.float32))
        x = c.x + scale * d32.astype(jnp.float64)
        r_new = b - matvec_hi(x)
        rn_new = norm(r_new)
        k = c.k + 1
        stalled = rn_new >= rn * 0.5
        reason = jnp.where(
            rn_new <= tol, StopReason.CONVERGED,
            jnp.where(k >= max_outer, StopReason.MAXITER,
                      jnp.where(stalled, StopReason.BREAKDOWN,
                                StopReason.RUNNING))).astype(jnp.int32)
        return _IRCarry(k, x, rn_new, c.inner_total + st.k, reason)

    x0 = jnp.zeros_like(b)
    r0 = norm(b)
    init_reason = jnp.where(r0 <= tol, StopReason.CONVERGED,
                            StopReason.RUNNING).astype(jnp.int32)
    init = _IRCarry(jnp.int32(0), x0, r0, jnp.int32(0), init_reason)
    final = jax.lax.while_loop(cond, body, init)
    return final.x, KrylovState(final.inner_total, final.resid, final.reason), None


_INNER_CACHE = {}


def _rr_enabled() -> bool:
    """Residual-replacement CG inside the dd-chain (PST_RR=0 reverts to
    restart-per-pass corrections)."""
    import os
    return os.environ.get("PST_RR", "1") != "0"


def _cached_inner_op(precond_lo, method, inner_maxiter, restart, chain=1):
    """Like ``_cached_inner`` but the operator AND the tolerance are traced
    ARGUMENTS of the jitted graph instead of closed-over constants:
    repeated solves with same-structure matrices whose values change
    (Newton steps bumping the Jacobian diagonal) and adaptive tolerances
    (Newton's forcing terms) reuse one compilation."""
    from ..ops import matvec as op_matvec
    key = ("op", id(precond_lo), method, inner_maxiter, restart, chain)
    ent = _INNER_CACHE.get(key)
    if ent is not None and ent[0] is precond_lo:
        return ent[1]

    @jax.jit
    def inner(A_dev, r32, inner_tau):
        mv = lambda v: op_matvec(A_dev, v)
        d, k = _chained_correction(method, mv, precond_lo, r32, inner_tau,
                                   inner_maxiter, restart, chain)
        return jnp.concatenate([d, k.astype(d.dtype)[None]])

    if len(_INNER_CACHE) > 64:
        _INNER_CACHE.pop(next(iter(_INNER_CACHE)))
    _INNER_CACHE[key] = (precond_lo, inner)
    return inner


def _one_solve(method, mv, papply, r32, inner_tau, inner_maxiter, restart):
    """``method``: "cg" | "richardson" | "gmres[:cgs2][:flex]" — GMRES
    options ride in the method string so every jit-cache key in this
    module inherits them without widening each signature."""
    if method == "cg":
        d, st, _ = cg_solve(mv, r32, maxiter=inner_maxiter,
                            tau=inner_tau, precond=papply)
    elif method == "richardson":
        d, st, _ = richardson_solve(mv, r32, maxiter=inner_maxiter,
                                    tau=inner_tau, precond=papply)
    else:
        opts = method.split(":")[1:]
        d, st, _ = gmres_solve(mv, r32, maxiter=inner_maxiter,
                               tau=inner_tau, precond=papply,
                               restart=restart,
                               orthog="cgs2" if "cgs2" in opts else "mgs",
                               flexible="flex" in opts,
                               check_true_residual=False)
    return d, st.k


def _chained_correction(method, mv, papply, r32, inner_tau, inner_maxiter,
                        restart, chain):
    """One (or ``chain`` f32-residual-chained) inner correction.

    With chain=2, the second solve corrects the f32 true residual of the
    first INSIDE the same jitted dispatch — one host round-trip buys
    ~(per-pass reduction)^2, halving the number of outer refinement
    passes.  The
    second solve is skipped (lax.cond) when the first already met the
    tolerance."""
    d, k = _one_solve(method, mv, papply, r32, inner_tau, inner_maxiter,
                      restart)
    for _ in range(chain - 1):
        r2 = r32 - mv(d)
        s2 = jnp.sqrt(jnp.sum(r2 * r2))
        rn0 = jnp.sqrt(jnp.sum(r32 * r32))
        s2_safe = jnp.where(s2 > 0, s2, 1.0)

        def go(_):
            d2, k2 = _one_solve(method, mv, papply, r2 / s2_safe,
                                inner_tau, inner_maxiter, restart)
            return s2_safe * d2, k2

        d2, k2 = jax.lax.cond(s2 > inner_tau * rn0, go,
                              lambda _: (jnp.zeros_like(d), jnp.int32(0)),
                              None)
        d = d + d2
        k = k + k2
    return d, k


def _cached_inner_pair(apply_fn, method, inner_maxiter, restart, chain=1):
    """Operator AND preconditioner state AND tolerance as traced arguments
    — maximal reuse: a re-formed preconditioner with the same structure
    (Newton steps re-factoring the Jacobian) hits the same compiled graph.
    ``apply_fn(state, v)`` must be a stable module-level function
    (Preconditioner.traced)."""
    from ..ops import matvec as op_matvec
    key = ("pair", id(apply_fn), method, inner_maxiter, restart, chain)
    ent = _INNER_CACHE.get(key)
    if ent is not None and ent[0] is apply_fn:
        return ent[1]

    @jax.jit
    def inner(A_dev, prec_state, r32, inner_tau):
        mv = lambda v: op_matvec(A_dev, v)
        papply = lambda v: apply_fn(prec_state, v)
        d, k = _chained_correction(method, mv, papply, r32, inner_tau,
                                   inner_maxiter, restart, chain)
        return jnp.concatenate([d, k.astype(d.dtype)[None]])

    if len(_INNER_CACHE) > 64:
        _INNER_CACHE.pop(next(iter(_INNER_CACHE)))
    _INNER_CACHE[key] = (apply_fn, inner)
    return inner


def _cached_dd_chain(apply_fn, method, inner_maxiter, restart, chain,
                     first_tau, hi_matvec=False, replace_every=None):
    """One-dispatch refinement chain: ``chain`` f32 inner corrections, each
    against an ACCURATE f64 residual computed in-graph.

    The f32-residual chaining in ``_chained_correction`` saturates after
    one step — the chained residual's own f32 rounding error
    (~eps32·kappa·‖r‖) is as large as the residual it feeds the next
    correction.  Here the chained residual is full f64
    (``ops.spmv.ell_spmv_f64`` / the f64 DIA), so
    every step multiplies the true reduction: (eps32·kappa)^chain per
    dispatch — ~4 upload/dispatch/fetch round trips become ONE.

    Floor-aware inner tolerances: a pass's achievable TRUE-residual
    reduction is floored at ~eps32·kappa(A) no matter how far the inner
    recurrence residual is pushed, so iterating every pass to a fixed
    inner_tau=1e-6 wastes 2-3× iterations grinding past the floor
    (measured: ~70 total inner its on DH-15 vs the reference's 20 f64
    its).  Each pass k>1 instead targets half the reduction the previous
    pass actually ACHIEVED (``f_obs``, observed in-graph from the f64
    residuals) — probing geometrically deeper until the floor bites,
    never burning iterations the floor will throw away.  The first pass
    of a solve has no observation and uses ``first_tau``; the host loop
    threads ``f_obs`` across re-dispatches.

    Operator (f32 + f64), preconditioner state, start vector and
    tolerances all ride as traced arguments — Newton re-factorizations
    reuse the compiled graph.  Steps after convergence are skipped by
    ``lax.cond``.
    """
    apply_fn, precond_lo = apply_fn
    rr = method == "cg" and _rr_enabled()
    key = ("ddchain", id(apply_fn), id(precond_lo), method, inner_maxiter,
           restart, chain, first_tau, rr, hi_matvec, replace_every)
    ent = _INNER_CACHE.get(key)
    if ent is not None and ent[0] is apply_fn and ent[2] is precond_lo:
        return ent[1]

    from ..ops import matvec as op_matvec
    from ..ops.spmv import ell_spmv_f64

    # x64=None (the common whole-solve-in-one-dispatch case) builds the
    # zero start vector IN-GRAPH — saves a 0-filled device upload
    @functools.partial(jax.jit, static_argnames=("x_is_zero",))
    def run(A_lo, prec_state, A64, b64, x64, tol64, inner_tau, f0,
            overshoot, x_is_zero=False):
        if x_is_zero:
            x64 = jnp.zeros_like(b64)
        mv = lambda v: op_matvec(A_lo, v)
        papply = (precond_lo if apply_fn is None
                  else (lambda v: apply_fn(prec_state, v)))
        from ..sparse.device import EllMatrix, EllTMatrix
        # hi-precision residual matvec: f64 gathers for ELL (slot-major
        # EllTMatrix preferred); DIA f64 is the plain shift-and-fma
        if isinstance(A64, EllTMatrix):
            from ..ops.spmv import ellt_spmv_f64
            mv_hi = ellt_spmv_f64
        elif isinstance(A64, EllMatrix):
            mv_hi = ell_spmv_f64
        else:
            mv_hi = lambda M, v: op_matvec(M, v)
        # internal target: `overshoot`·tol — driving the device solve
        # past the user tolerance is what bounds the SOLUTION error
        # (err = ‖A⁻¹r‖ fluctuates ~50× with the spectral direction of
        # the final residual; only a deeper ‖r‖ bounds it robustly).
        # The host still verifies/reports against the user tau.
        tol_int = overshoot * tol64
        x = x64
        k_tot = jnp.int32(0)
        f_obs = f0                       # observed per-pass reduction (0 = none yet)
        rn_prev = jnp.zeros((), jnp.float64)   # >0 marks "previous pass ran"
        for _ in range(chain):
            r = b64 - mv_hi(A64, x)
            rn = jnp.sqrt(jnp.sum(r * r))
            # update the floor estimate from the reduction the previous
            # pass actually achieved (skipped passes leave it untouched)
            f_obs = jnp.where(rn_prev > 0,
                              jnp.clip(rn / jnp.maximum(rn_prev, 1e-300),
                                       0.0, 1.0),
                              f_obs)
            scale = jnp.where(rn > 0, rn, 1.0)
            # adaptive inner tolerance, the larger of two bounds:
            # * the remaining (overshoot-deepened) gap tol_int/‖r‖ —
            #   the final pass stops the moment the internal target is
            #   met instead of grinding to a fixed tau;
            # * half the previously OBSERVED per-pass reduction — no pass
            #   pushes its recurrence residual far past the eps32·kappa
            #   floor of the true residual (probing 2× deeper each pass
            #   keeps well-conditioned problems converging geometrically).
            gap = tol_int / scale
            tau_est = jnp.where(f_obs > 0, 0.5 * f_obs,
                                jnp.float64(first_tau))
            if rr or hi_matvec:
                # residual replacement / the f64 recurrence remove the
                # per-pass floor: one pass closes the whole remaining
                # gap, so the tolerance is just the gap
                tau_k = jnp.clip(gap.astype(jnp.float32),
                                 jnp.float32(1e-30), jnp.float32(0.5))
            else:
                tau_k = jnp.clip(
                    jnp.maximum(gap, tau_est).astype(jnp.float32),
                    inner_tau, jnp.float32(0.5))

            def go(_):
                if rr:
                    from .krylov import cg_solve_rr
                    # replacement cadence: preconditioned solves converge
                    # fast (and nonsymmetric-prec drift bites early), so
                    # verify every 6 steps; unpreconditioned runs go
                    # thousands of slow-reducing iterations where each
                    # f64 replacement matvec costs several f32
                    # recurrence steps — the drop trigger still fires on fast
                    # reduction, so a longer window only skips no-op
                    # verifications (drift/window ~ eps32·reduction)
                    unprec = apply_fn is None and precond_lo is None
                    re_eff = (replace_every if replace_every is not None
                              else (48 if unprec else 6))
                    d64, st, _ = cg_solve_rr(
                        mv, r / scale, mv_hi=lambda v: mv_hi(A64, v),
                        maxiter=inner_maxiter, tau=tau_k, precond=papply,
                        replace_every=re_eff,
                        hi_matvec=hi_matvec)
                    return scale * d64, st.k
                if hi_matvec:
                    # hi path for the non-CG methods: the whole inner
                    # solve runs on the f64 operator with the f32
                    # preconditioner riding as the (flexible) inexact
                    # part — f64-grade iteration counts and final
                    # residual direction, one dispatch, no restart
                    # chain (GMRES basis/Givens in f64; FGMRES because
                    # an f32-rounded preconditioner is not a fixed
                    # linear operator).
                    mv64 = lambda v: mv_hi(A64, v)
                    papply64 = ((lambda v: papply(
                        v.astype(jnp.float32)).astype(jnp.float64))
                        if (apply_fn is not None or precond_lo is not None)
                        else None)
                    r64 = r / scale
                    if method == "richardson":
                        d64, st, _ = richardson_solve(
                            mv64, r64, maxiter=inner_maxiter,
                            tau=tau_k.astype(jnp.float64),
                            precond=papply64)
                    elif method == "cg":
                        # reachable only with PST_RR=0 (rr normally owns
                        # the hi CG path): plain f64 CG on the hi
                        # operator with the f32 preconditioner
                        d64, st, _ = cg_solve(
                            mv64, r64, maxiter=inner_maxiter,
                            tau=tau_k.astype(jnp.float64),
                            precond=papply64)
                    else:
                        opts = method.split(":")[1:]
                        d64, st, _ = gmres_solve(
                            mv64, r64, maxiter=inner_maxiter,
                            tau=tau_k.astype(jnp.float64),
                            precond=papply64, restart=restart,
                            orthog="cgs2" if "cgs2" in opts else "mgs",
                            flexible=True, check_true_residual=False)
                    return scale * d64, st.k
                r32 = (r / scale).astype(jnp.float32)
                d, k = _one_solve(method, mv, papply, r32, tau_k,
                                  inner_maxiter, restart)
                return (scale * d.astype(jnp.float64)), k

            will_run = rn > tol_int
            d64, k = jax.lax.cond(will_run, go,
                                  lambda _: (jnp.zeros_like(x),
                                             jnp.int32(0)), None)
            rn_prev = jnp.where(will_run, rn, jnp.zeros_like(rn))
            x = x + d64
            k_tot = k_tot + k
        r = b64 - mv_hi(A64, x)
        rn = jnp.sqrt(jnp.sum(r * r))
        f_obs = jnp.where(rn_prev > 0,
                          jnp.clip(rn / jnp.maximum(rn_prev, 1e-300),
                                   0.0, 1.0),
                          f_obs)
        # one array out -> one device->host fetch per dispatch
        return jnp.concatenate([x, k_tot.astype(jnp.float64)[None],
                                rn[None], f_obs[None]])

    if len(_INNER_CACHE) > 64:
        _INNER_CACHE.pop(next(iter(_INNER_CACHE)))
    _INNER_CACHE[key] = (apply_fn, run, precond_lo)
    return run


def ir_solve_dd(mv_hi_host, b, *, A_lo, A64, tau=1e-10, inner_tau=1e-6,
                inner_maxiter=500, method="cg", precond_pair=None,
                precond_lo=None, restart=None, chain=4, max_outer=20,
                first_tau=1e-4, overshoot=0.25, hi_matvec=None,
                replace_every=None):
    """Host-driven refinement where each dispatch runs a ``chain``-step
    f64-residual correction chain fully on device (``_cached_dd_chain``).

    ``mv_hi_host``: numpy f64 matvec for the final host-verified residual
    (the in-graph residual is ~2^-48-grade; the host check is exact f64).
    ``first_tau``: inner tolerance of the very first pass, before any
    per-pass reduction has been observed (see ``_cached_dd_chain``); the
    observed floor rides across re-dispatches.  Semantics and return
    match ``ir_solve_host``.

    ``overshoot``: internal residual target as a fraction of the user
    tolerance (success is still judged/reported against ``tau``).  The
    default 0.25 only covers recurrence-vs-true slack; accuracy-critical
    callers pass 0.01-0.005 to bound the SOLUTION error — err = ‖A⁻¹r‖
    moves ~50× with the final residual's spectral direction, so only a
    deeper ‖r‖ bounds it (costs 2-5 extra inner iterations at the
    preconditioned rates).

    ``replace_every``: residual-replacement cadence override (None =
    auto: 6 preconditioned / 48 unpreconditioned).  WEAK symmetric
    preconditioners (block-Jacobi on a 2.1M-row vector Laplacian: ~1800
    iterations) want the long cadence too.

    ``hi_matvec``: run the inner recurrence matvec in f64
    (krylov.cg_solve_rr(hi_matvec=True) for CG; f64 FGMRES/Richardson
    for the others).  None = auto: on whenever a preconditioner is
    present (few iterations, f64-grade counts and error), off for
    unpreconditioned long recurrences.
    """
    import numpy as np

    if hi_matvec is None:
        hi_matvec = precond_pair is not None or precond_lo is not None
    if (method == "cg" and _rr_enabled()) or hi_matvec:
        # residual replacement / the f64 inner recurrence converge
        # through the eps32·kappa floor in ONE continuous pass — a chain
        # of passes would only compile `chain` unrolled copies of the
        # biggest graph in the framework (rr while_loop + preconditioner
        # + f64 matvec) for lax.cond to skip at runtime.  The
        # host loop still re-dispatches on the rare non-converged return.
        chain = 1
    apply_fn, prec_state = (precond_pair if precond_pair is not None
                            else (None, None))
    run = _cached_dd_chain((apply_fn, precond_lo), method, inner_maxiter,
                           restart, chain, float(first_tau),
                           hi_matvec=hi_matvec, replace_every=replace_every)

    b_h = np.asarray(b, dtype=np.float64)
    b_norm = float(np.linalg.norm(b_h))
    tol = tau * b_norm
    b64 = jnp.asarray(b_h)
    x_h = np.zeros_like(b_h)
    tol64 = jnp.float64(tol)
    tau32 = jnp.float32(inner_tau)

    inner_total = 0
    rn_prev = float("inf")
    reason = StopReason.MAXITER
    f_obs = 0.0
    max_disp = max(1, -(-max_outer // chain))
    from ..utils.timing import Timer
    for disp in range(max_disp):
        with Timer("refine.dd_compute"):
            fut = run(A_lo, prec_state, A64, b64,
                      None if disp == 0 else jnp.asarray(x_h),
                      tol64, tau32, jnp.float64(f_obs),
                      jnp.float64(overshoot), x_is_zero=(disp == 0))
            jax.block_until_ready(fut)
        with Timer("refine.dd_fetch"):
            packed = np.asarray(fut)
        x_h = packed[:-3]
        pass_k = int(packed[-3])
        inner_total += pass_k
        rn_dev = float(packed[-2])
        f_obs = float(packed[-1])
        # exact host residual: covers the 2^-48 in-graph representation
        with Timer("refine.host_resid"):
            rn = float(np.linalg.norm(b_h - mv_hi_host(x_h)))
        if rn <= tol:
            reason = StopReason.CONVERGED
            break
        if rn >= rn_prev * 0.5 and rn_dev >= rn_prev * 0.5:
            reason = (StopReason.MAXITER if rn <= b_norm * 1e-3
                      else StopReason.BREAKDOWN)
            break
        rn_prev = rn
    else:
        rn = float(np.linalg.norm(b_h - mv_hi_host(x_h)))
        if rn <= tol:
            reason = StopReason.CONVERGED

    return (jnp.asarray(x_h),
            KrylovState(jnp.int32(inner_total), jnp.float64(rn),
                        jnp.int32(int(reason))), None)


def ir_solve_multi(mm_hi, B64, *, inner_solve, col_norm, bc,
                   inner_ops=None,
                   tau: float = 1e-10, max_outer: int = 20,
                   inner_tau: float = 1e-6, overshoot: float = 0.25):
    """Blocked mixed-precision refinement: the lockstep analog of
    ``ir_solve_dd`` (VERDICT r4 item 2 — mixed precision × multi-RHS
    must compose, no per-column loop).

    Layout-generic: ``B64`` is a block of k right-hand sides in ANY
    layout ((n, k) columns or (k, n) rows);
    ``col_norm(V) -> (k,)`` reduces a block to per-RHS norms and
    ``bc(s)`` broadcasts per-RHS scalars back over the layout.

    Each outer pass computes the per-column TRUE residual block in f64
    in-graph (``mm_hi``: blocked f64 matvec), scales every running
    column to O(1), zeroes converged columns (the lockstep inner then
    freezes them at iteration 0 — per-column chain termination), and
    runs ONE blocked f32 inner solve (``inner_solve(R32, tau32) ->
    (D32, k_arr)``) for all columns: one operator pass per iteration
    for the whole block, the k× amortization the kernels buy.

    Per-column semantics match the single-RHS mixed route: convergence
    at ``‖r_j‖ <= tau·‖b_j‖`` on the f64 residual, stall -> BREAKDOWN,
    ``overshoot`` deepens the internal target the same way
    (ir_solve_dd docstring).  Reference bar: per-column PCG semantics,
    PCGSolver.py:109-138.

    Returns (X64, KrylovState of per-column vectors, None).

    ``mm_hi`` may be a plain callable ``X -> A@X`` or a pair
    ``(fn, Aop)`` with ``fn(Aop, X) -> A@X``: the pair form passes the
    operator (and B64) through jit as TRACED arguments instead of
    closed-over constants, which would bake the operand tables into the
    compiled program.  ``inner_ops`` does the same for the inner
    solve's f32 operands: when given, ``inner_solve(inner_ops, R32,
    tau32)`` is called with the pytree passed through jit.
    """
    import numpy as np

    if isinstance(mm_hi, tuple):
        mm_fn, Aop = mm_hi
    else:
        mm_fn, Aop = (lambda _, X: mm_hi(X)), None
    if inner_ops is None:
        inner_fn = lambda _, R32, tau32: inner_solve(R32, tau32)
    else:
        inner_fn = inner_solve

    b_norms = col_norm(B64)
    tols = tau * b_norms
    tol_int = overshoot * tols

    @jax.jit
    def one_pass(Aop, iops, B64, X, done, tau32):
        R = B64 - mm_fn(Aop, X)
        rn = col_norm(R)
        run = (~done) & (rn > tol_int)
        scale = jnp.where(rn > 0, rn, 1.0)
        R32 = jnp.where(bc(run), (R / bc(scale)),
                        jnp.zeros_like(R)).astype(jnp.float32)
        D32, k_arr = inner_fn(iops, R32, tau32)
        X = X + bc(scale) * D32.astype(jnp.float64)
        return X, rn, k_arr

    @jax.jit
    def final_resid(Aop, B64, X):
        return col_norm(B64 - mm_fn(Aop, X))

    X = jnp.zeros_like(B64)
    k_tot = np.zeros(b_norms.shape[0], dtype=np.int64)
    rn_prev = np.full(b_norms.shape[0], np.inf)
    tau32 = jnp.float32(inner_tau)
    stalled = np.zeros(b_norms.shape[0], dtype=bool)
    rn_h = np.asarray(final_resid(Aop, B64, X))
    for _ in range(max_outer):
        done_h = (rn_h <= np.asarray(tols)) | stalled
        if done_h.all():
            break
        X, rn, k_arr = one_pass(Aop, inner_ops, B64, X,
                                jnp.asarray(done_h), tau32)
        k_tot += np.asarray(k_arr, dtype=np.int64) * (~done_h)
        rn_h = np.asarray(final_resid(Aop, B64, X))
        newly_stalled = (~done_h) & (rn_h >= rn_prev * 0.5) \
            & (rn_h > np.asarray(tols))
        stalled |= newly_stalled
        rn_prev = np.where(done_h, rn_prev, rn_h)

    conv = rn_h <= np.asarray(tols)
    reason = np.where(conv, int(StopReason.CONVERGED),
                      np.where(stalled, int(StopReason.BREAKDOWN),
                               int(StopReason.MAXITER))).astype(np.int32)
    return (X,
            KrylovState(jnp.asarray(k_tot.astype(np.int32)),
                        jnp.asarray(rn_h),
                        jnp.asarray(reason)), None)


def _cached_inner(matvec_lo, precond_lo, method, inner_maxiter, inner_tau,
                  restart):
    """Build (or reuse) the jitted inner-solve graph.

    Tracing + lowering a Krylov graph costs seconds; re-creating the jit
    per ``ir_solve_host`` call made that the dominant solve cost.  Keyed
    on the operator/preconditioner identities plus the static knobs;
    strong references keep the ids stable."""
    key = (id(matvec_lo), id(precond_lo), method, inner_maxiter,
           inner_tau, restart)
    ent = _INNER_CACHE.get(key)
    if ent is not None and ent[0] is matvec_lo and ent[1] is precond_lo:
        return ent[2]

    @jax.jit
    def inner(r32):
        if method == "cg":
            d, st, _ = cg_solve(matvec_lo, r32, maxiter=inner_maxiter,
                                tau=inner_tau, precond=precond_lo)
        elif method == "richardson":
            # stationary iteration (e.g. AMG-V-cycle-as-solver,
            # reference VCycleSolver.py:79-91) under f64 refinement
            d, st, _ = richardson_solve(matvec_lo, r32,
                                        maxiter=inner_maxiter,
                                        tau=inner_tau, precond=precond_lo)
        else:
            d, st, _ = gmres_solve(matvec_lo, r32, maxiter=inner_maxiter,
                                   tau=inner_tau, precond=precond_lo,
                                   restart=restart,
                                   check_true_residual=False)
        # pack the correction and the iteration count into ONE array so a
        # host-driven outer loop pays a single device->host fetch per pass
        # (k < 2^24 is exact in f32)
        return jnp.concatenate([d, st.k.astype(d.dtype)[None]])

    if len(_INNER_CACHE) > 64:        # bounded: drop the oldest entry
        _INNER_CACHE.pop(next(iter(_INNER_CACHE)))
    _INNER_CACHE[key] = (matvec_lo, precond_lo, inner)
    return inner


def ir_solve_host(matvec_hi, matvec_lo, b, *, tau: float = 1e-10,
                  max_outer: int = 20, inner_tau: float = 1e-6,
                  inner_maxiter: int = 500, method: str = "cg",
                  precond_lo=None, restart=None,
                  host_residual: bool = False, A_lo=None,
                  precond_pair=None, chain: int = 1):
    """Host-driven iterative refinement: the inner f32 Krylov solve is one
    (small) jitted computation re-dispatched per outer pass, and the f64
    residual update runs as a second jitted step.

    Rationale: the fully-jitted ``ir_solve`` nests while_loops three deep;
    this variant keeps each compiled graph small at the cost of
    ~max_outer dispatches (negligible against the solve).  Semantics
    match ``ir_solve``.
    """
    import numpy as np
    from ..core import StopReason

    if host_residual:
        # ``matvec_hi`` is a host (numpy f64) callable: the outer loop
        # lives on the host anyway, so the high-precision residual runs
        # there; only the f32 inner Krylov solve touches the device.
        b_h = np.asarray(b, dtype=np.float64)
        x_h = np.zeros_like(b_h)

        def residual(xh):
            r = b_h - matvec_hi(xh)
            return r, float(np.linalg.norm(r))
    else:
        b = b.astype(jnp.float64)
        # cache the jitted residual graph on the operator's identity —
        # a per-call closure would retrace on every solve; b rides as a
        # traced argument
        rkey = ("resid", id(matvec_hi))
        ent = _INNER_CACHE.get(rkey)
        if ent is not None and ent[0] is matvec_hi:
            residual_dev = ent[1]
        else:
            @jax.jit
            def residual_dev(b_, x):
                r = b_ - matvec_hi(x)
                return r, jnp.sqrt(jnp.sum(r * r))
            _INNER_CACHE[rkey] = (matvec_hi, residual_dev)

        def residual(x):
            r, rn = residual_dev(b, x)
            return r, float(rn)

        x_h = jnp.zeros_like(b)
        b_h = b
    b_norm = float(np.linalg.norm(np.asarray(b_h)))
    tol = tau * b_norm

    # chained dispatches only pay off while the residual is far from the
    # target (each chained sub-solve re-runs full inner iterations);
    # the host picks the chained graph only when more than ~one plain
    # pass of reduction is still needed
    _CHAIN_FAR = 1e4

    if A_lo is not None and precond_pair is not None:
        # operator, preconditioner state and tolerance all traced:
        # re-formed preconditioners (Newton) reuse the compiled graph
        apply_fn, prec_state = precond_pair
        inner_p1 = _cached_inner_pair(apply_fn, method, inner_maxiter,
                                      restart, 1)
        inner_pc = (inner_p1 if chain == 1 else _cached_inner_pair(
            apply_fn, method, inner_maxiter, restart, chain))
        tau32 = jnp.float32(inner_tau)

        def inner(r32, far=False):
            f = inner_pc if far else inner_p1
            return f(A_lo, prec_state, r32, tau32)
    elif A_lo is not None:
        # the device matrix and the tolerance ride as traced arguments:
        # same-structure matrices with different values (Newton Jacobians)
        # and adaptive tolerances share one compiled inner graph
        inner_o1 = _cached_inner_op(precond_lo, method, inner_maxiter,
                                    restart, 1)
        inner_oc = (inner_o1 if chain == 1 else _cached_inner_op(
            precond_lo, method, inner_maxiter, restart, chain))
        tau32 = jnp.float32(inner_tau)

        def inner(r32, far=False):
            f = inner_oc if far else inner_o1
            return f(A_lo, r32, tau32)
    else:
        _inner_plain = _cached_inner(matvec_lo, precond_lo, method,
                                     inner_maxiter, float(inner_tau),
                                     restart)
        inner = lambda r32, far=False: _inner_plain(r32)

    x = x_h
    inner_total = 0
    rn_prev = float("inf")
    rn_first = None
    reason = StopReason.MAXITER
    k = 0
    for k in range(1, max_outer + 1):
        r, rn = residual(x)
        if rn_first is None:
            rn_first = rn
        if rn <= tol:
            reason = StopReason.CONVERGED
            break
        if rn >= rn_prev * 0.5:
            # stalled: the f32 inner floor was reached.  If refinement
            # already improved the residual substantially, report MAXITER
            # (success under failOnMaxiter=False semantics — e.g. Newton
            # forcing-term solves that only need a good-enough step);
            # BREAKDOWN is reserved for making no progress at all.
            reason = (StopReason.MAXITER
                      if rn <= rn_first * 1e-3 else StopReason.BREAKDOWN)
            break
        rn_prev = rn
        scale = rn if rn > 0 else 1.0
        r32 = jnp.asarray((np.asarray(r) / scale).astype(np.float32)) \
            if host_residual else (r / scale).astype(jnp.float32)
        packed = inner(r32, far=(rn > tol * _CHAIN_FAR))
        if host_residual:
            packed_h = np.asarray(packed)          # one fetch: d32 + k
            inner_total += int(packed_h[-1])
            x = x + scale * packed_h[:-1].astype(np.float64)
        else:
            inner_total += int(packed[-1])
            x = x + scale * packed[:-1].astype(jnp.float64)
    else:
        # loop exhausted: x changed since the last residual — measure once
        _, rn = residual(x)
        if rn <= tol:
            reason = StopReason.CONVERGED

    # break paths leave `rn` as the residual of the returned x; no
    # recompute (on the device-residual path that's a full f64 matvec)
    x_out = jnp.asarray(x) if host_residual else x
    return x_out, KrylovState(jnp.int32(inner_total),
                              jnp.float64(float(rn)),
                              jnp.int32(int(reason))), None
