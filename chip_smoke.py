#!/usr/bin/env python3
"""Smoke test of the solver stack on one GPU: the proof that the system
still starts and solves on the card.

    python chip_smoke.py              # phases a-g on one GPU
    python chip_smoke.py --devices 4  # phases a and c on a 4-GPU mesh,
                                      # each against its one-GPU solution

Every phase drives the library through its user entry points
(``pst.solve`` and the factory API), solves to tau=1e-10 unless stated,
and prints one JSON line: wall time split into setup and solve,
iterations, the true relative residual computed on the host in f64, the
relative error against the manufactured solution, and the card's name
and power limit.  A phase fails when its residual is above tau or its
error above 1e-6 (phases that print an ``err_bound`` are held to it
instead).  After all phases the last line is the device record
``{"ok": true, "device": {...}}``; if any phase failed, or JAX finds no
GPU, the script exits non-zero and prints no such line.

Each phase is a function of its size, so the tests call it small on CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

TAU = 1e-10
ERR_LIMIT = 1e-6


def card() -> str | None:
    """``name, power.limit`` of every visible card, as nvidia-smi gives
    them (None when there is no nvidia-smi)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    return "; ".join(lines) if r.returncode == 0 and lines else None


def _emit(rec: dict) -> dict:
    print(json.dumps(rec), flush=True)
    return rec


def _rel(num, den) -> float:
    return float(np.linalg.norm(num) / np.linalg.norm(den))


def _check(phase: str, resid: float, err: float,
           err_bound: float | None = None, **rec) -> dict:
    """One phase record; ``ok`` holds it to tau and the error limit."""
    limit = ERR_LIMIT if err_bound is None else err_bound
    ok = bool(resid <= TAU and err <= limit)
    out = dict(phase=phase, ok=ok, resid=resid, err=err, tau=TAU)
    if err_bound is not None:
        out["err_bound"] = err_bound
    out.update(rec)
    out["card"] = card()
    return _emit(out)


def _timed_solves(solver, A, b):
    """Cold solve (setup + compile + solve), then the same solve again
    with the matrix and preconditioner frozen (steady state)."""
    t0 = time.perf_counter()
    st = solver.solve(A, b)
    np.asarray(st.soln)
    cold = time.perf_counter() - t0
    solver.freeze_matrix()
    if hasattr(solver, "freeze_prec"):
        solver.freeze_prec()
    t0 = time.perf_counter()
    st = solver.solve(A, b)
    x = np.asarray(st.soln, dtype=np.float64)
    warm = time.perf_counter() - t0
    return st, x, cold, warm


def _gmg_levels(m: int) -> int:
    """Coarsen (m -> (m-1)/2) down to a grid of at most 31 points."""
    lev = 1
    while m > 31 and m % 2 == 1:
        m = (m - 1) // 2
        lev += 1
    return lev


def laplacian_kappa(m: int) -> float:
    """Condition number of the 2-D FD Dirichlet Laplacian on m×m."""
    t = np.pi / (2 * (m + 1))
    return float((np.cos(t) / np.sin(t)) ** 2)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_structured(m: int, precision: str, galerkin: str = "auto",
                     mesh=None, tag: str = "a", seed: int = 0):
    """2-D FD Laplacian, PCG + grid GMG through the factory API."""
    import pysolvers_tpu as pst

    t0 = time.perf_counter()
    H = pst.problems.fd_laplacian_2d(m)
    x_true = np.random.default_rng(seed).random(H.shape[0])
    b = H.matvec(x_true)
    gen = time.perf_counter() - t0
    prec = pst.GMGPreconditionerType(dims=(m, m), num_iters=2,
                                     num_levels=_gmg_levels(m),
                                     smoother="jacobi", galerkin=galerkin)
    solver = pst.PCG(pst.CommonSolverArgs(maxiter=200, tau=TAU),
                     precond=prec, precision=precision,
                     mesh=mesh).make_solver()
    st, x, cold, warm = _timed_solves(solver, H, b)
    kappa = laplacian_kappa(m)
    rec = _check(f"{tag}_{precision}", _rel(b - H.matvec(x), b),
                 _rel(x - x_true, x_true),
                 err_bound=kappa * TAU, n=H.shape[0],
                 gen_s=gen, setup_s=cold - warm, solve_s=warm,
                 iters=int(st.iters), galerkin=galerkin,
                 devices=1 if mesh is None else int(mesh.devices.size))
    rec["x"] = x
    return rec


def phase_unstructured(m: int, seed: int = 0):
    """Unstructured FEM Poisson, PCG + SA-AMG (factory API, mixed), then a
    second right-hand side on the frozen hierarchy."""
    import pysolvers_tpu as pst
    from pysolvers_tpu.problems.fem import fem_poisson_2d_unstructured

    t0 = time.perf_counter()
    H0 = fem_poisson_2d_unstructured(m, seed=seed)
    H = H0.permute_symmetric(H0.rcm_perm())
    rng = np.random.default_rng(seed)
    x_true = rng.random(H.shape[0])
    b = H.matvec(x_true)
    gen = time.perf_counter() - t0
    solver = pst.PCG(pst.CommonSolverArgs(maxiter=400, tau=TAU),
                     precond=pst.AMG(num_iters=2, num_levels=4,
                                     smoother="jacobi"),
                     precision="mixed").make_solver()
    st, x, cold, warm = _timed_solves(solver, H, b)
    rec = _check("c_amg", _rel(b - H.matvec(x), b),
                 _rel(x - x_true, x_true), n=H.shape[0], gen_s=gen,
                 setup_s=cold - warm, solve_s=warm, iters=int(st.iters))
    # reuse: a second right-hand side on the frozen hierarchy
    x2_true = rng.random(H.shape[0])
    b2 = H.matvec(x2_true)
    t0 = time.perf_counter()
    st2 = solver.solve(H, b2)
    x2 = np.asarray(st2.soln, dtype=np.float64)
    resolve = time.perf_counter() - t0
    rec2 = _check("c_amg_reuse", _rel(b2 - H.matvec(x2), b2),
                  _rel(x2 - x2_true, x2_true), n=H.shape[0], setup_s=0.0,
                  solve_s=resolve, iters=int(st2.iters))
    rec["x"], rec["H"], rec["b"], rec["x_true"] = x, H, b, x_true
    return rec, rec2


def phase_nonsymmetric(m: int, seed: int = 0):
    """Convection-diffusion, GMRES + right ILUT (mixed).

    The operator is scaled by h² to unit stencil size: ILUT's threshold
    (drop |l_ik| <= drop_tol·||a_i||) compares dimensionless multipliers
    with row-scaled values, so on the 1/h²-scaled operator it drops every
    L entry once m >= 31 and leaves a far weaker preconditioner."""
    import pysolvers_tpu as pst
    from pysolvers_tpu.sparse.host import HostCSR

    t0 = time.perf_counter()
    H = pst.problems.fd_convection_diffusion_2d(m)
    H = HostCSR(H.indptr, H.indices, H.data / (m + 1.0) ** 2, H.shape)
    x_true = np.random.default_rng(seed).random(H.shape[0])
    b = H.matvec(x_true)
    gen = time.perf_counter() - t0
    solver = pst.GMRES(pst.CommonSolverArgs(maxiter=300, tau=TAU),
                       precond=pst.RightILUT(), restart=60,
                       precision="mixed").make_solver()
    st, x, cold, warm = _timed_solves(solver, H, b)
    return _check("d_gmres_ilut", _rel(b - H.matvec(x), b),
                  _rel(x - x_true, x_true), n=H.shape[0], gen_s=gen,
                  setup_s=cold - warm, solve_s=warm, iters=int(st.iters))


class _ForcedBratu:
    """Bratu F(u) - f with f = F(u*): a manufactured solution u*."""

    def __init__(self, base, u_star):
        self.base = base
        self.n = base.n
        self.f = base.evalF(u_star)

    def evalF(self, u):
        return self.base.evalF(u) - self.f

    def evalJ(self, u):
        return self.base.evalJ(u)


def phase_nonlinear(m: int, seed: int = 0):
    """Bratu2D, inexact Newton with PCG + grid GMG inner solves (mixed)."""
    import pysolvers_tpu as pst
    from pysolvers_tpu.problems.bratu import Bratu2DHostOuter

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    u_star = rng.random(m * m)
    prob = _ForcedBratu(
        Bratu2DHostOuter(pst.problems.Bratu2D(m=m, alpha=0.5, fmt="dia")),
        u_star)
    setup = time.perf_counter() - t0
    inner = pst.PCG(pst.CommonSolverArgs(maxiter=400, tau=1e-12),
                    precond=pst.GMGPreconditionerType(
                        dims=(m, m), num_iters=2,
                        num_levels=_gmg_levels(m), smoother="jacobi"),
                    precision="mixed")
    newton = pst.NewtonSolver(pst.SolverConfig(maxiter=30, tau=TAU),
                              solver=inner, min_lin_tol=1e-6,
                              freeze_prec=True)
    u0 = np.zeros(prob.n)
    t0 = time.perf_counter()
    st = newton.solve(prob, u0)
    solve = time.perf_counter() - t0
    u = np.asarray(st.soln, dtype=np.float64)
    F0 = prob.evalF(u0)
    return _check("e_newton", _rel(prob.evalF(u), F0),
                  _rel(u - u_star, u_star), n=prob.n, setup_s=setup,
                  solve_s=solve, iters=int(st.iters))


def phase_blocked(m: int, k: int = 8, seed: int = 0):
    """Vector Laplacian (b=2) as a BdiaMatrix, k right-hand sides through
    pst.solve, mixed."""
    import pysolvers_tpu as pst

    t0 = time.perf_counter()
    H = pst.problems.fd_vector_laplacian_2d(m, b=2)
    A = pst.BdiaMatrix.from_host_csr(H, b=2)
    X_true = np.random.default_rng(seed).random((H.shape[0], k))
    B = np.stack([H.matvec(X_true[:, j]) for j in range(k)], axis=1)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = pst.solve(A, B, tau=TAU, maxiter=20000, method="cg",
                   precision="mixed")
    X = np.asarray(st.soln, dtype=np.float64)
    solve = time.perf_counter() - t0
    resid = max(_rel(B[:, j] - H.matvec(X[:, j]), B[:, j])
                for j in range(k))
    err = max(_rel(X[:, j] - X_true[:, j], X_true[:, j]) for j in range(k))
    return _check("f_bdia_k8", resid, err, n=H.shape[0], k=k,
                  setup_s=setup, solve_s=solve, iters=int(st.iters))


def _abs_product(H, x) -> float:
    """max_i (|A| |x|)_i: the scale of an SpMV's rounding error."""
    from pysolvers_tpu.sparse.host import HostCSR
    Habs = HostCSR(H.indptr, H.indices, np.abs(H.data).astype(np.float64),
                   H.shape)
    return float(Habs.matvec(np.abs(x).astype(np.float64)).max())


def _time_op(fn, *args, reps: int = 20) -> float:
    import jax
    jax.block_until_ready(fn(*args))          # compile + warm
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def phase_spmv(m_dia: int, m_ell: int, reps: int = 20):
    """f32 DIA and ELL SpMV rates on the stream model, with a triad over
    the DIA bytes measured in the same process.  Each SpMV is checked
    against the host f64 CSR product of the same f32 data (max relative
    error 1e-5: an f32 sum of at most 9 terms taken in another order)."""
    import jax
    import jax.numpy as jnp
    import pysolvers_tpu as pst
    from pysolvers_tpu.problems.fem import fem_poisson_2d_unstructured
    from pysolvers_tpu.sparse.host import HostCSR
    from pysolvers_tpu.utils.profiling import spmv_sol

    recs = []
    H = pst.problems.fd_laplacian_2d(m_dia, dtype=np.float32)
    A = pst.DiaMatrix.from_host_csr(H)
    n = H.shape[0]
    x = np.random.default_rng(1).random(n).astype(np.float32)
    xd = jnp.asarray(x)
    dia_fn = jax.jit(pst.matvec)
    y = np.asarray(dia_fn(A, xd), dtype=np.float64)
    ref = H.matvec(x.astype(np.float64))
    scale = _abs_product(H, x)
    dia_err = float(np.abs(y - ref).max() / scale)
    t_dia = _time_op(dia_fn, A, xd, reps=reps)
    sol_dia = spmv_sol(H.nnz, n, "dia", n_diags=len(A.offsets))

    # triad a = b + s*c over the same bytes as the DIA SpMV
    nt = int(sol_dia.bytes_moved // 12)
    tb = jnp.ones(nt, jnp.float32)
    tc = jnp.full(nt, 2.0, jnp.float32)
    triad = jax.jit(lambda u, v: u + 3.0 * v)
    t_triad = _time_op(triad, tb, tc, reps=reps)
    peak = 12.0 * nt / t_triad / 1e9
    del tb, tc

    G0 = fem_poisson_2d_unstructured(m_ell)
    G = G0.permute_symmetric(G0.rcm_perm())
    G32 = HostCSR(G.indptr, G.indices, G.data.astype(np.float32), G.shape)
    E = pst.EllMatrix.from_host_csr(G32)
    xe = np.random.default_rng(2).random(G.shape[0]).astype(np.float32)
    xed = jnp.asarray(xe)
    ell_fn = jax.jit(pst.matvec)
    ye = np.asarray(ell_fn(E, xed), dtype=np.float64)
    refe = G32.matvec(xe.astype(np.float64))
    scale_e = _abs_product(G32, xe)
    ell_err = float(np.abs(ye - refe).max() / scale_e)
    t_ell = _time_op(ell_fn, E, xed, reps=reps)
    sol_ell = spmv_sol(G.nnz, G.shape[0], "ell")

    for name, sol, t, err, nn, dbytes in (
            ("g_dia_spmv", sol_dia, t_dia, dia_err, n,
             int(np.asarray(A.diags).nbytes)),
            ("g_ell_spmv", sol_ell, t_ell, ell_err, G.shape[0],
             int(E.data.nbytes + E.cols.nbytes))):
        gbps = sol.bytes_moved / t / 1e9
        ok = bool(err <= 1e-5)
        recs.append(_emit(dict(phase=name, ok=ok, n=nn, max_rel_err=err,
                               table_bytes=dbytes, time_s=t, gbps=gbps,
                               triad_gbps=peak, triad_share=gbps / peak,
                               card=card())))
    return recs


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def run_one_card(sizes: dict) -> list:
    recs = []
    recs.append(phase_structured(sizes["a"], "native"))
    recs.append(phase_structured(sizes["a"], "mixed"))
    recs.append(phase_structured(sizes["b"], "mixed", galerkin="device",
                                 tag="b"))
    recs.extend(phase_unstructured(sizes["c"]))
    recs.append(phase_nonsymmetric(sizes["d"]))
    recs.append(phase_nonlinear(sizes["e"]))
    recs.append(phase_blocked(sizes["f"]))
    recs.extend(phase_spmv(sizes["g_dia"], sizes["g_ell"]))
    return recs


def phase_partition_amg(H, b, x_true, mesh, x_ref, crossover: int = 1024):
    """Partition-local AMG (parallel/amg_dist.py) over the mesh: f64 PCG
    with the sharded V-cycle, compared with the one-card solution."""
    import jax
    import jax.numpy as jnp
    from pysolvers_tpu.linear.krylov import cg_solve
    from pysolvers_tpu.parallel.amg_dist import (build_partition_hierarchy,
                                                 ph_matvec, ph_pad_vector,
                                                 pv_cycle)

    t0 = time.perf_counter()
    ph = build_partition_hierarchy(H, mesh, num_levels=4,
                                   crossover=crossover, dtype=np.float64)
    bg = ph_pad_vector(ph, b)
    setup = time.perf_counter() - t0

    # solved past tau (f64 PCG reaches 1e-12 in a few more iterations) so
    # the comparison with the one-card solution sees the one-card error,
    # not this solve's
    @jax.jit
    def run(bq):
        x, st, _ = cg_solve(
            lambda v: ph_matvec(ph, v), bq, maxiter=400, tau=0.01 * TAU,
            precond=lambda r: pv_cycle(ph, r, jnp.zeros_like(r)))
        return x, st.k

    t0 = time.perf_counter()
    x, k = run(bg)
    x = np.asarray(x, dtype=np.float64)[: H.shape[0]]
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.asarray(run(bg)[0])
    warm = time.perf_counter() - t0
    return _check("c4_partition_amg", _rel(b - H.matvec(x), b),
                  _rel(x - x_true, x_true), n=H.shape[0],
                  devices=int(mesh.devices.size), setup_s=setup + cold - warm,
                  solve_s=warm, iters=int(k),
                  diff_vs_one_card=_rel(x - x_ref, x_ref))


def run_multi_card(sizes: dict, n_dev: int) -> list:
    from pysolvers_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_dev)
    recs = []
    for precision in ("native", "mixed"):
        one = phase_structured(sizes["a"], precision)
        many = phase_structured(sizes["a"], precision, mesh=mesh, tag="a4")
        diff = _rel(many["x"] - one["x"], one["x"])
        many["ok"] = bool(many["ok"] and one["ok"] and diff <= 1e-8)
        recs += [one, many, _emit(dict(phase=f"a4_{precision}_vs_one",
                                       ok=many["ok"], diff=diff))]
    c1, _ = phase_unstructured(sizes["c"])
    c4 = phase_partition_amg(c1["H"], c1["b"], c1["x_true"], mesh, c1["x"],
                             crossover=sizes.get("crossover", 1024))
    c4["ok"] = bool(c4["ok"] and c1["ok"]
                    and c4["diff_vs_one_card"] <= 1e-8)
    recs += [c1, c4]
    return recs


FULL = dict(a=2047, b=8191, c=1025, d=1023, e=1023, f=1023,
            g_dia=4095, g_ell=2049)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: the multi-card phases only (a and c)")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX runs on {devs[0].platform!r}", file=sys.stderr)
        return 2
    if len(devs) < args.devices:
        print(f"need {args.devices} GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2

    import pysolvers_tpu  # noqa: F401  (fails here outside the repo)
    from pysolvers_tpu.utils.platform import enable_persistent_cache
    enable_persistent_cache()

    t0 = time.perf_counter()
    if args.devices == 1:
        recs = run_one_card(FULL)
    else:
        recs = run_multi_card(FULL, args.devices)
    failed = [r["phase"] for r in recs if not r["ok"]]
    print(json.dumps(dict(total_s=time.perf_counter() - t0,
                          failed=failed)), flush=True)
    print(card(), flush=True)
    if failed:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
