#!/usr/bin/env python
"""Diagnose the DH-15 iteration-count gap (VERDICT r2 item 1).

Splits the 42-vs-20 PCG+IC inner-iteration gap into its two candidate
causes by running plain f64 PCG on the HOST (numpy, exact trisolves) with:
  a) our IC(t) factor (ict_factor, effective drop = drop_tol*CALIBRATION),
     factored from the f64 matrix;
  b) our IC(t) factor factored from the f32-rounded matrix (the battery's
     route: prep(Hp32));
  c) the reference's construction: SuperLU spilu(no-pivot) -> D^-1/2 U
     (ICPreconditioner.py:40-56) — expected ~20 iterations.
If (a)~(c): the factor is fine and the gap is rr-CG mechanics.
If (a)>>(c): the drop rule / calibration makes a weaker factor.

Same split for GMRES+ILUT (51 vs 20), plus final true-residual and
error-vs-exact columns for the accuracy gap (err 3.16e-5 vs 1.96e-6).
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import scipy.sparse as sp
import scipy.sparse.linalg as spla

import pysolvers_tpu as pst
from pysolvers_tpu.linear.ilu import (ICPreconditionerType,
                                      ILUTPreconditionerType,
                                      ict_factor, ilut_factor)
from pysolvers_tpu.sparse.host import HostCSR


def to_scipy(H):
    return sp.csr_matrix((H.data, H.indices, H.indptr), shape=H.shape)


def pcg_f64(A, b, apply_M, tau=1e-10, maxiter=600):
    """Plain f64 PCG (reference PCGSolver.py:109-138 semantics)."""
    x = np.zeros_like(b)
    r = b.copy()
    bn = np.linalg.norm(b)
    u = apply_M(r)
    udr = u @ r
    p = u.copy()
    for k in range(1, maxiter + 1):
        Ap = A @ p
        alpha = udr / (p @ Ap)
        x += alpha * p
        r -= alpha * Ap
        if np.linalg.norm(r) <= tau * bn:
            return x, k, np.linalg.norm(r) / bn
        u = apply_M(r)
        udr_new = u @ r
        p = u + (udr_new / udr) * p
        udr = udr_new
    return x, maxiter, np.linalg.norm(r) / bn


def gmres_f64(A, b, apply_M, tau=1e-10, maxiter=300):
    """Plain f64 right-preconditioned GMRES (full, no restart)."""
    n = b.shape[0]
    m = maxiter
    bn = np.linalg.norm(b)
    Q = np.zeros((m + 1, n))
    H = np.zeros((m + 1, m))
    beta = bn
    Q[0] = b / beta
    g = np.zeros(m + 1)
    g[0] = beta
    cs = np.zeros((m, 2))
    for k in range(m):
        u = A @ apply_M(Q[k])
        for j in range(k + 1):
            H[j, k] = Q[j] @ u
            u -= H[j, k] * Q[j]
        H[k + 1, k] = np.linalg.norm(u)
        if H[k + 1, k] > 0:
            Q[k + 1] = u / H[k + 1, k]
        for j in range(k):
            c, s = cs[j]
            hj, hj1 = H[j, k], H[j + 1, k]
            H[j, k] = c * hj + s * hj1
            H[j + 1, k] = -s * hj + c * hj1
        r_ = np.hypot(H[k, k], H[k + 1, k])
        c, s = H[k, k] / r_, H[k + 1, k] / r_
        cs[k] = (c, s)
        H[k, k] = r_
        H[k + 1, k] = 0.0
        gk, gk1 = g[k], g[k + 1]
        g[k] = c * gk + s * gk1
        g[k + 1] = -s * gk + c * gk1
        if abs(g[k + 1]) <= tau * bn:
            y = np.linalg.solve(np.triu(H[:k + 1, :k + 1]), g[:k + 1])
            x = apply_M(Q[:k + 1].T @ y)
            return x, k + 1, np.linalg.norm(b - A @ x) / bn
    y = np.linalg.solve(np.triu(H[:m, :m]), g[:m])
    x = apply_M(Q[:m].T @ y)
    return x, m, np.linalg.norm(b - A @ x) / bn


def main():
    lev = int(sys.argv[1]) if len(sys.argv) > 1 else 15
    H, x_exact, b = pst.problems.dh_test_problem(lev)
    n = H.shape[0]
    A = to_scipy(H).astype(np.float64)
    b = b.astype(np.float64)

    # battery route: RCM permutation first, factor the permuted
    perm = H.rcm_perm()
    Hp = H.permute_symmetric(perm)
    Ap_ = to_scipy(Hp).astype(np.float64)
    bp = b[perm]
    Hp32 = HostCSR(Hp.indptr, Hp.indices, Hp.data.astype(np.float32),
                   Hp.shape)
    Hp64 = HostCSR(Hp.indptr, Hp.indices, Hp.data.astype(np.float64),
                   Hp.shape)

    def ic_apply(Lc):
        L = to_scipy(Lc).tocsr().astype(np.float64)
        LT = L.T.tocsr()
        return lambda v: spla.spsolve_triangular(
            LT, spla.spsolve_triangular(L, v, lower=True), lower=False)

    def ilut_apply(LU):
        L, U = LU
        Ls = to_scipy(L).tocsr().astype(np.float64)
        Us = to_scipy(U).tocsr().astype(np.float64)
        return lambda v: spla.spsolve_triangular(
            Us, spla.spsolve_triangular(Ls, v, lower=True),
            lower=False, unit_diagonal=False)

    out = []

    def rec(name, solver, apply_M, Amat, rhs, nnzf):
        t0 = time.perf_counter()
        x, k, rel = solver(Amat, rhs, apply_M)
        dt = time.perf_counter() - t0
        # error measured on the unpermuted solution
        xu = np.empty_like(x)
        xu[perm] = x
        err = np.linalg.norm(xu - x_exact)
        r = dict(name=name, iters=int(k), rel_resid=float(rel),
                 err=float(err), nnz_factor=int(nnzf), t=round(dt, 2))
        out.append(r)
        print(json.dumps(r), flush=True)

    cal = 0.1    # the round-2 fixed calibration point (pre-auto baseline)

    # (a) our IC from f64 matrix
    Lc64 = ict_factor(Hp64, 1e-3 * cal, 15.0)
    rec("IC ours(f64 input)", pcg_f64, ic_apply(Lc64), Ap_, bp, Lc64.nnz)
    # (b) our IC from f32 matrix (battery route)
    Lc32 = ict_factor(Hp32, 1e-3 * cal, 15.0)
    rec("IC ours(f32 input)", pcg_f64, ic_apply(Lc32), Ap_, bp, Lc32.nnz)
    # (c) reference construction: spilu no-pivot -> D^-1/2 U
    ilu = spla.spilu(Ap_.tocsc(), drop_tol=1e-3, fill_factor=15,
                     diag_pivot_thresh=0.0,
                     options=dict(ColPerm="NATURAL"))
    d = ilu.U.diagonal()
    Lref = (sp.diags(1.0 / np.sqrt(d)) @ ilu.U).T.tocsr()
    rec("IC reference(spilu)", pcg_f64,
        lambda v: spla.spsolve_triangular(
            Lref.T.tocsr(), spla.spsolve_triangular(Lref, v, lower=True),
            lower=False), Ap_, bp, Lref.nnz)

    # same for ILUT + GMRES
    LU64 = ilut_factor(Hp64, 1e-3 * cal, 15.0)
    rec("ILUT ours(f64 input)", gmres_f64, ilut_apply(LU64), Ap_, bp,
        LU64[0].nnz + LU64[1].nnz)
    LU32 = ilut_factor(Hp32, 1e-3 * cal, 15.0)
    rec("ILUT ours(f32 input)", gmres_f64, ilut_apply(LU32), Ap_, bp,
        LU32[0].nnz + LU32[1].nnz)
    ilu2 = spla.spilu(Ap_.tocsc(), drop_tol=1e-3, fill_factor=15)
    rec("ILUT reference(spilu)", gmres_f64, lambda v: ilu2.solve(v),
        Ap_, bp, ilu2.nnz)


if __name__ == "__main__":
    main()
