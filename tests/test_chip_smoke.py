"""chip_smoke.py: every phase at a tiny size on CPU, and the refusal to
print a device record without a GPU."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _ok(rec):
    assert rec["ok"], rec
    assert rec["resid"] <= cs.TAU
    assert rec["solve_s"] >= 0 and "setup_s" in rec and "card" in rec
    return rec


@pytest.mark.parametrize("precision", ["native", "mixed"])
def test_structured(precision):
    rec = _ok(cs.phase_structured(31, precision))
    assert rec["err"] <= rec["err_bound"] and rec["iters"] > 0


def test_structured_device_galerkin():
    rec = _ok(cs.phase_structured(63, "mixed", galerkin="device", tag="b"))
    assert rec["phase"] == "b_mixed" and rec["galerkin"] == "device"


def test_unstructured_and_reuse():
    first, reuse = cs.phase_unstructured(25)
    _ok(first)
    _ok(reuse)
    assert reuse["phase"] == "c_amg_reuse" and reuse["err"] <= cs.ERR_LIMIT


def test_nonsymmetric():
    assert _ok(cs.phase_nonsymmetric(23))["err"] <= cs.ERR_LIMIT


def test_nonlinear():
    assert _ok(cs.phase_nonlinear(15))["err"] <= cs.ERR_LIMIT


def test_blocked():
    rec = _ok(cs.phase_blocked(15, k=8))
    assert rec["k"] == 8 and rec["err"] <= cs.ERR_LIMIT


def test_spmv_rates():
    dia, ell = cs.phase_spmv(31, 33, reps=2)
    for rec in (dia, ell):
        assert rec["ok"] and rec["max_rel_err"] <= 1e-5
        assert rec["gbps"] > 0 and rec["triad_gbps"] > 0


def test_multi_device_phases():
    """The --devices path on 4 of the suite's virtual CPU devices: each
    mesh solve agrees with its one-device solution."""
    recs = cs.run_multi_card(dict(a=31, c=25, crossover=32), 4)
    assert all(r["ok"] for r in recs), [r for r in recs if not r["ok"]]
    assert {r["phase"] for r in recs} >= {
        "a4_native", "a4_mixed", "c4_partition_amg"}


def test_no_gpu_no_device_record():
    """On a machine without a GPU the script exits non-zero and prints
    no device record."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=ROOT)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        try:
            assert "device" not in json.loads(line)
        except json.JSONDecodeError:
            pass
