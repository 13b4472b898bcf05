"""Utils tests: Timer, Tab, checkpoint, roofline model."""
import numpy as np

import jax.numpy as jnp

from pysolvers_tpu.utils import Timer, Tab, SpeedOfLight, spmv_sol
from pysolvers_tpu.utils.checkpoint import (save_pytree, load_pytree,
                                            save_solve_state,
                                            load_solve_state)
from pysolvers_tpu.sparse import DiaMatrix
from pysolvers_tpu.problems import fd_laplacian_1d


class TestTimer:
    def test_accumulates(self):
        Timer.reset()
        with Timer("unit"):
            pass
        with Timer("unit"):
            pass
        assert Timer.total("unit") >= 0.0
        assert Timer._counts["unit"] == 2
        Timer.report()
        Timer.reset()


class TestTab:
    def test_nesting(self):
        base = str(Tab())
        with Tab():
            assert len(str(Tab())) > len(base)
        assert str(Tab()) == base


class TestCheckpoint:
    def test_pytree_roundtrip(self, tmp_path):
        A = DiaMatrix.from_host_csr(fd_laplacian_1d(32))
        p = str(tmp_path / "A.npz")
        save_pytree(p, A)
        A2 = load_pytree(p, A)
        np.testing.assert_allclose(np.asarray(A2.diags), np.asarray(A.diags))
        assert A2.offsets == A.offsets

    def test_solve_state_roundtrip(self, tmp_path):
        p = str(tmp_path / "s.npz")
        x = jnp.arange(5.0)
        save_solve_state(p, x, [1.0, 0.1], iters=2)
        x2, hist, iters = load_solve_state(p)
        np.testing.assert_allclose(np.asarray(x2), np.asarray(x))
        assert iters == 2 and len(hist) == 2

    def test_shape_mismatch_rejected(self, tmp_path):
        p = str(tmp_path / "bad.npz")
        save_pytree(p, jnp.zeros(4))
        try:
            load_pytree(p, jnp.zeros(5))
            assert False, "expected ValueError"
        except ValueError:
            pass


class TestRoofline:
    def test_spmv_sol_memory_bound(self):
        s = spmv_sol(nnz=5_000_000, n=1_000_000, fmt="ell", peak_gbps=1000.0)
        assert s.bytes_moved == 5_000_000 * 8 + 2 * 1_000_000 * 4
        assert s.sol_seconds() == s.bytes_moved / 1e12
        assert 0 < s.achieved_fraction(s.sol_seconds() * 2) <= 0.5001
        assert s.achieved_gbps(s.sol_seconds()) == 1000.0

    def test_needs_measured_peak(self):
        """No nominal peak table: a roofline share without a measured
        peak is an error, never a silent default."""
        s = spmv_sol(nnz=5, n=5, fmt="dia", n_diags=1)
        try:
            s.sol_seconds()
            assert False, "expected ValueError"
        except ValueError:
            pass
