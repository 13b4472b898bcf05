#!/usr/bin/env python
"""Measure the reference PySolvers on this host (the parity configurations).

Runs the six SURVEY §6 configurations against /root/reference with stub
PyTab/PyTimer packages (the author's unpublished helper deps).  Emits JSON
lines {config, n, time_s, iters, err}.

Usage:  python benchmarks/run_reference.py [--out FILE]
"""
import argparse
import json
import os
import sys
import tempfile
import time

# import stubs for the reference checkout, under the temp directory
STUBS = os.path.join(tempfile.gettempdir(), "pst_refstubs")


def _make_stubs():
    os.makedirs(f"{STUBS}/PyTab", exist_ok=True)
    os.makedirs(f"{STUBS}/PyTimer", exist_ok=True)
    with open(f"{STUBS}/PyTab/__init__.py", "w") as f:
        f.write("class Tab:\n"
                "    def __init__(self, *a, **k): pass\n"
                "    def __str__(self): return '  '\n"
                "    def indent(self, *a, **k): pass\n"
                "    def unindent(self, *a, **k): pass\n")
    with open(f"{STUBS}/PyTimer/__init__.py", "w") as f:
        f.write(
            "import time\n"
            "class Timer:\n"
            "    _all = {}\n"
            "    def __init__(self, name=''):\n"
            "        self.name = name; self.t0 = None\n"
            "        Timer._all.setdefault(name, 0.0)\n"
            "    def start(self): self.t0 = time.perf_counter()\n"
            "    def stop(self):\n"
            "        if self.t0 is not None:\n"
            "            Timer._all[self.name] += time.perf_counter()-self.t0\n"
            "            self.t0 = None\n"
            "    @classmethod\n"
            "    def report(cls):\n"
            "        for k, v in cls._all.items(): print(k, v)\n"
            "class TimeMonitor(Timer): pass\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--lev", type=int, default=10)
    args = ap.parse_args()

    _make_stubs()
    sys.path.insert(0, STUBS)
    sys.path.insert(0, "/root/reference")
    sys.path.insert(0, "/root/reference/examples")
    # the reference loads '../TestMatrices/...' relative to examples/
    if args.out:
        args.out = os.path.abspath(args.out)
    os.chdir("/root/reference/examples")

    import numpy as np
    import numpy.linalg as npla
    from PySolvers import CommonSolverArgs
    from PySolvers.Linear import (PCG, GMRES, RightIC, RightILUT, AMG,
                                  AMGVCycle)
    from DHTestProblem import DHTestProblem
    from FDLaplacian1D import FDLaplacian1D

    # The reference's GMRESSolver.solve reads self.precond, which no class
    # ever sets (GMRESSolver.py:71) — GMRES+preconditioner crashes as
    # shipped.  Minimal shim so the baseline can be measured at all:
    from PySolvers.Linear.GMRESSolver import GMRESSolver
    GMRESSolver.precond = None

    results = []

    def run(config, fn):
        t0 = time.perf_counter()
        iters, err, success = fn()
        dt = time.perf_counter() - t0
        rec = dict(config=config, time_s=round(dt, 6), iters=iters,
                   err=(float(err) if np.isfinite(err) else None),
                   success=bool(success))
        results.append(rec)
        print(json.dumps(rec), flush=True)

    lev = args.lev
    A, b, xEx = DHTestProblem(lev)

    def pcg_ic():
        s = PCG(control=CommonSolverArgs(maxiter=500, tau=1e-10),
                precond=RightIC()).makeSolver()
        r = s.solve(A, b)
        return r.iters(), npla.norm(r.soln() - xEx) if r.success() else np.inf, r.success()

    def gmres_ilut():
        s = GMRES(control=CommonSolverArgs(maxiter=500, tau=1e-10),
                  precond=RightILUT()).makeSolver()
        r = s.solve(A, b)
        return r.iters(), npla.norm(r.soln() - xEx) if r.success() else np.inf, r.success()

    def pcg_amg():
        s = PCG(control=CommonSolverArgs(maxiter=500, tau=1e-10),
                precond=AMG(numIters=2)).makeSolver()
        r = s.solve(A, b)
        return r.iters(), npla.norm(r.soln() - xEx) if r.success() else np.inf, r.success()

    def vcycle():
        s = AMGVCycle(control=CommonSolverArgs(maxiter=200, tau=1e-10)
                      ).makeSolver()
        r = s.solve(A, b)
        return r.iters(), npla.norm(r.soln() - xEx) if r.success() else np.inf, r.success()

    def cg_lap1d():
        # reference FDLaplacian1D(a, b, m) returns the NEGATIVE Laplacian
        # (FDLaplacian1D.py:8-13); negate for an SPD CG system
        A1 = (-FDLaplacian1D(0.0, 1.0, 1000)).tocsr()
        x = np.random.default_rng(0).random(1000)
        b1 = A1 @ x
        s = PCG(control=CommonSolverArgs(maxiter=4000, tau=1e-10)).makeSolver()
        r = s.solve(A1, b1)
        return r.iters(), npla.norm(r.soln() - x) if r.success() else np.inf, r.success()

    run(f"DH{lev}+PCG+IC", pcg_ic)
    run(f"DH{lev}+GMRES+ILUT", gmres_ilut)
    run(f"DH{lev}+PCG+AMG2", pcg_amg)
    run(f"DH{lev}+VCycle", vcycle)
    run("Lap1D(1000)+CG", cg_lap1d)

    if args.out:
        with open(args.out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
