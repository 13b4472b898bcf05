#!/usr/bin/env python
"""Distributed solve walk-through: row-partitioned CG over a device mesh.

Runs anywhere: on several GPUs it uses the real cards; with
--cpu-devices N it builds a virtual CPU mesh.

Shows the three distribution layers:
  1. shard_map SpMV with ppermute neighbor halos (banded matrix),
  2. GSPMD-inserted all-reduces for the CG dot products,
  3. a zero-communication block-Jacobi ILU preconditioner.
"""
import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=64,
                    help="grid size (n = m^2 unknowns)")
    ap.add_argument("--cpu-devices", type=int, default=0)
    ap.add_argument("--platform", default=None,
                    help="accepted for test-runner compatibility; the "
                         "platform is pinned via --cpu-devices")
    ap.add_argument("--tau", type=float, default=1e-10)
    args = ap.parse_args()

    import jax
    if args.cpu_devices:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu_devices)
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import pysolvers_tpu as pst
    from pysolvers_tpu.parallel import (make_mesh, shard_dia, dist_dia_spmv,
                                        pad_vector_dia,
                                        build_block_jacobi_ilu,
                                        block_jacobi_apply)

    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    print(f"mesh: {n_dev} × {jax.devices()[0].device_kind}")

    H = pst.problems.fd_laplacian_2d(args.m)
    n = H.shape[0]
    rng = np.random.default_rng(0)
    x_exact = rng.random(n)
    A = shard_dia(H, mesh)                       # row slabs + band halos
    b = pad_vector_dia(A, H.matvec(x_exact))
    M = build_block_jacobi_ilu(H, mesh, A.n_pad, sweeps=10)

    # truncated-sweep block-ILU is not symmetric, so pair it with
    # (F)GMRES; use CG + block-IC or more sweeps for SPD preconditioning
    @jax.jit
    def solve(A, b, M):
        return pst.gmres_solve(lambda v: dist_dia_spmv(A, v), b,
                               maxiter=2000, restart=80, tau=args.tau,
                               orthog="cgs2", flexible=True,
                               precond=lambda r: block_jacobi_apply(M, r))

    x, st, _ = solve(A, b, M)
    err = np.linalg.norm(np.asarray(x)[:n] - x_exact)
    print(f"n={n}: reason={pst.StopReason(int(st.reason)).name} "
          f"iters={int(st.k)} resid={float(st.resid):.3e} err={err:.3e}")

    # the same solve as a factory ONE-LINER: mesh= shards everything,
    # precision="mixed" wraps the sharded f32 solve in host f64
    # refinement so tau=1e-10 is reached with f32 device arithmetic
    st2 = pst.PCG(pst.CommonSolverArgs(maxiter=4000, tau=args.tau),
                  precision="mixed", mesh=mesh).make_solver() \
        .solve(H, H.matvec(x_exact))
    err2 = np.linalg.norm(np.asarray(st2.soln) - x_exact)
    print(f"factory mesh+mixed: success={st2.success} "
          f"iters={st2.iters} resid={st2.resid:.3e} err={err2:.3e}")

    ok = (int(st.reason) == pst.StopReason.CONVERGED) and st2.success
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
