"""Example CLIs run end-to-end (the reference's examples are its de-facto
integration tests — SURVEY §4)."""
import os
import subprocess
import sys

import pytest

_EX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "examples")


def run_example(name, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(_EX) + os.pathsep + \
        env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, os.path.join(_EX, name), "--platform", "cpu", *args],
        capture_output=True, text=True, timeout=420, env=env)
    assert r.returncode == 0, f"{name} failed:\n{r.stdout}\n{r.stderr}"
    return r.stdout


class TestExamples:
    def test_pcg_ic(self):
        out = run_example("pcg_example_ic.py", "--meshLev", "8",
                          "--tau", "1e-10")
        assert "succeeded" in out

    def test_gmres_ilut(self):
        out = run_example("gmres_example_ilut.py", "--meshLev", "8",
                          "--tau", "1e-10")
        assert "succeeded" in out

    def test_pcg_ic_mixed_precision(self):
        # the mixed route exposed on the parity CLI: f32 device
        # kernels + f64 residual refinement
        out = run_example("pcg_example_ic.py", "--meshLev", "8",
                          "--tau", "1e-10", "--precision", "mixed")
        assert "succeeded" in out

    def test_vcycle(self):
        out = run_example("vcycle_example.py", "--meshLev", "8",
                          "--levels", "2")
        assert "succeeded" in out

    def test_direct(self):
        out = run_example("direct_solver_example.py", "--meshLev", "7")
        assert "succeeded" in out

    def test_newton_root2(self):
        out = run_example("newton_example_root2.py")
        assert "1.41421356" in out

    def test_newton_arctan(self):
        out = run_example("newton_example_arctan.py")
        assert "succeeded" in out

    def test_bratu_small(self):
        out = run_example("bratu_example.py", "--m", "12")
        assert "succeeded" in out

    def test_pcg_amg(self):
        out = run_example("pcg_example_amg.py", "--meshLev", "8")
        assert "succeeded" in out

    def test_distributed(self):
        out = run_example("distributed_example.py", "--m", "32",
                          "--cpu-devices", "8")
        assert "CONVERGED" in out

    def test_bdia(self):
        # block-structured multi-dof solve on the block-DIA kernel
        out = run_example("bdia_example.py", "--m", "16", "--b", "2")
        assert "error vs exact" in out
