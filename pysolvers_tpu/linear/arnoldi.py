"""Standalone Arnoldi factorizations and Givens utilities.

Capability parity with the reference's classroom modules
(Linear/ArnoldiGS.py:11-83 — classical and modified Gram-Schmidt Arnoldi
building A·Q_k = Q_{k+1}·H̄; Linear/Givens.py:7-34 — rotation find/apply).
Here both are jitted device functions over a fixed subspace dimension m;
the GMRES driver in krylov.py embeds its own fused recurrences, and these
standalone versions serve testing/teaching and spectral estimation.
"""
from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST


def givens_coefficients(a, b):
    """(c, s) with [c s; -s c]ᵀ... zeroing b (reference Givens.py:7-12).
    hypot, not sqrt(a*a+b*b): the squared form overflows f32 at
    |a| ~ 1.8e19 and silently zeroes the rotation."""
    r = jnp.hypot(a, b)
    safe = r > 0
    c = jnp.where(safe, a / jnp.where(safe, r, 1.0), 1.0)
    s = jnp.where(safe, b / jnp.where(safe, r, 1.0), 0.0)
    return c, s


def apply_givens(v, c, s, i, j):
    """Rotate entries (i, j) of v (reference Givens.py:16-24)."""
    vi, vj = v[i], v[j]
    return v.at[i].set(c * vi + s * vj).at[j].set(-s * vi + c * vj)


def arnoldi(matvec: Callable, q0: jax.Array, m: int,
            method: str = "mgs") -> Tuple[jax.Array, jax.Array]:
    """Run m Arnoldi steps from unit vector q0.

    Returns (Q, H) with Q (m+1, n) orthonormal rows and H (m+1, m) upper
    Hessenberg satisfying  matvec(Qᵀ)ᵀ = H·... i.e. A Q[k] = Σ H[j,k] Q[j].
    ``method``: "mgs" (modified GS, reference ArnoldiGS.py:52-83) or
    "cgs" (classical GS, reference ArnoldiGS.py:11-50).
    """
    n = q0.shape[0]
    dtype = q0.dtype
    Q0 = jnp.zeros((m + 1, n), dtype=dtype).at[0].set(
        q0 / jnp.linalg.norm(q0))
    H0 = jnp.zeros((m + 1, m), dtype=dtype)

    def step(k, carry):
        Q, H = carry
        u = matvec(Q[k])
        if method == "cgs":
            mask = (jnp.arange(m + 1) <= k).astype(dtype)
            h = jnp.matmul(Q, u, precision=_HI) * mask
            u = u - jnp.matmul(h, Q, precision=_HI)
        else:
            def mgs_body(j, carry):
                u, h = carry
                active = (j <= k).astype(dtype)
                hj = active * jnp.dot(Q[j], u, precision=_HI)
                return u - hj * Q[j], h.at[j].set(hj)
            u, h = jax.lax.fori_loop(0, m + 1, mgs_body,
                                     (u, jnp.zeros(m + 1, dtype=dtype)))
        beta = jnp.linalg.norm(u)
        h = h.at[k + 1].set(beta)
        qn = jnp.where(beta > 0, u / jnp.where(beta > 0, beta, 1.0),
                       jnp.zeros_like(u))
        Q = Q.at[k + 1].set(qn)
        H = H.at[:, k].set(h)
        return Q, H

    Q, H = jax.lax.fori_loop(0, m, step, (Q0, H0))
    return Q, H


def arnoldi_residual(matvec: Callable, Q: jax.Array, H: jax.Array):
    """‖A Q_m − Q_{m+1} H̄‖_F and ‖QQᵀ − I‖_F (the reference's self-test
    metrics, ArnoldiGS.py:98-133)."""
    m = H.shape[1]
    AQ = jax.vmap(matvec)(Q[:m])          # (m, n)
    recon = H.T @ Q                        # (m, n)
    fact_err = jnp.linalg.norm(AQ - recon)
    orth_err = jnp.linalg.norm(Q @ Q.T - jnp.eye(Q.shape[0], dtype=Q.dtype))
    return fact_err, orth_err
