"""Fully-jitted matrix-free Newton-Krylov.

The reference ships a broken NewtonKrylov module (Nonlinear/NewtonKrylov.py
imports nonexistent modules; SURVEY §2.2) whose intent was a self-contained
Newton-GMRES with total-iteration counting and adaptive tolerances.  This is
the device realization, and goes further than the reference could:

* the Jacobian is never formed — J(x)·v comes from ``jax.jvp`` (exact
  forward-mode AD of the residual function);
* the ENTIRE solve — Newton loop, inner Krylov, backtracking line search —
  is one ``lax.while_loop`` nest under a single jit: zero host round-trips;
* Eisenstat-Walker-style adaptive inner tolerance
  tau_lin = max(tol_fudge·||F||/r0, min_lin_tol) (reference Newton.py:62-73)
  and the Dennis-Schnabel sufficient-decrease backtracking rule
  (reference LineSearch.py:62-81), both expressed with masked fixed-trip
  loops.

Requires ``F`` to be a pure jax function (e.g. problems.Bratu2D.eval_f).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import StopReason
from ..linear.krylov import cg_solve, gmres_solve


class NKState(NamedTuple):
    k: jax.Array            # Newton iterations
    inner_total: jax.Array  # total Krylov iterations (the reference
    #                         NewtonKrylov's intent, :80,130)
    resid: jax.Array        # ||F(x)||
    reason: jax.Array


class _NKCarry(NamedTuple):
    k: jax.Array
    x: jax.Array
    Fx: jax.Array
    normF: jax.Array
    inner_total: jax.Array
    reason: jax.Array


def newton_krylov_solve(F: Callable, x0: jax.Array, *,
                        tau: float = 1e-10, maxiter: int = 30,
                        method: str = "gmres", inner_maxiter: int = 100,
                        restart: Optional[int] = None,
                        tol_fudge: float = 0.1, min_lin_tol: float = 1e-10,
                        ls_maxsteps: int = 15, ls_alpha: float = 1e-4,
                        ls_low: float = 0.1,
                        precond: Optional[Callable] = None,
                        eval_j: Optional[Callable] = None,
                        precond_from_j: Optional[Callable] = None):
    """Solve F(x) = 0.  Returns (x, NKState).

    Convergence: ||F|| <= r0·tau + tau (reference Newton.py:54).

    Default is matrix-free (J·v by jvp).  The EXPLICIT-Jacobian path
    (reference Newton.py:59 ``J = func.evalJ(x)``): pass ``eval_j(x)`` →
    device-matrix pytree (e.g. problems.Bratu2D's DIA diagonal bump); the
    inner Krylov then runs ``matvec(J, v)`` and ``precond_from_j(J, v)``
    can build a setup-free preconditioner (Jacobi/Chebyshev) from the
    CURRENT Jacobian each Newton step — all inside the single jitted
    while_loop.
    """
    norm = lambda v: jnp.sqrt(jnp.sum(v * v))
    x0 = jnp.asarray(x0)
    F0 = F(x0)
    r0 = norm(F0)
    tol = r0 * tau + tau

    def line_search(x, Fx, normF, p):
        """Masked fixed-trip backtracking (Dennis & Schnabel rule)."""

        def body(i, c):
            t, best_x, best_F, best_norm, done = c
            x_try = x + t * p
            F_try = F(x_try)
            n_try = norm(F_try)
            ok = jnp.isfinite(n_try) & (n_try <= (1.0 - ls_alpha * t) * normF)
            take = ok & ~done
            best_x = jnp.where(take, x_try, best_x)
            best_F = jnp.where(take, F_try, best_F)
            best_norm = jnp.where(take, n_try, best_norm)
            done = done | ok
            ratio = jnp.where(normF > 0, n_try / normF, 2.0)
            shrink = jnp.clip(jnp.where(jnp.isfinite(ratio) & (ratio > 0),
                                        0.5 / ratio, 0.5), ls_low, 0.5)
            return (t * shrink, best_x, best_F, best_norm, done)

        t0 = jnp.asarray(1.0, x.dtype)
        _, bx, bF, bn, done = jax.lax.fori_loop(
            0, ls_maxsteps, body, (t0, x, Fx, normF, jnp.bool_(False)))
        return bx, bF, bn, done

    def cond(c: _NKCarry):
        return c.reason == StopReason.RUNNING

    def body(c: _NKCarry):
        # adaptive linear tolerance (traced scalar — tolerances are only
        # compared against, so they need not be static under jit)
        tau_lin = jnp.minimum(
            jnp.maximum(tol_fudge * c.normF / jnp.maximum(r0, 1e-300),
                        min_lin_tol), 0.5)
        if eval_j is not None:
            from ..ops import matvec as op_matvec
            Jx = eval_j(c.x)
            mv = lambda v: op_matvec(Jx, v)
            papply = (precond if precond_from_j is None
                      else (lambda v: precond_from_j(Jx, v)))
        else:
            mv = lambda v: jax.jvp(F, (c.x,), (v,))[1]
            papply = precond
        if method == "cg":
            p, st, _ = cg_solve(mv, -c.Fx, maxiter=inner_maxiter,
                                tau=tau_lin, precond=papply)
        else:
            p, st, _ = gmres_solve(mv, -c.Fx, maxiter=inner_maxiter,
                                   tau=tau_lin, restart=restart,
                                   precond=papply,
                                   check_true_residual=False)
        x, Fx, normF, ls_ok = line_search(c.x, c.Fx, c.normF, p)
        k = c.k + 1
        inner_total = c.inner_total + st.k
        converged = normF <= tol
        reason = jnp.where(
            converged, StopReason.CONVERGED,
            jnp.where(~ls_ok, StopReason.LINESEARCH_FAIL,
                      jnp.where(k >= maxiter, StopReason.MAXITER,
                                StopReason.RUNNING))).astype(jnp.int32)
        return _NKCarry(k, x, Fx, normF, inner_total, reason)

    init_reason = jnp.where(r0 <= tol, StopReason.CONVERGED,
                            StopReason.RUNNING).astype(jnp.int32)
    init = _NKCarry(jnp.int32(0), x0, F0, r0, jnp.int32(0), init_reason)
    f = jax.lax.while_loop(cond, body, init)
    return f.x, NKState(f.k, f.inner_total, f.normF, f.reason)
