"""Line searches for Newton globalization.

Capability parity with reference PySolvers/Nonlinear/LineSearch.py:4-81:
abstract search protocol, TrivialLinesearch (full step), and
SimpleBacktrack — the Dennis & Schnabel sufficient-decrease backtracking:
accept x + t·p when ||F(x+t·p)|| <= (1 − alpha·t)·||F0||, shrinking t by
0.5/ratio clamped to [low, 0.5] otherwise (LineSearch.py:62-81).

The residual evaluations run on device; the (short, data-dependent)
backtracking loop runs on host — it is outer control flow with a handful of
trips, the same setup/execute split the Newton driver uses.
"""
from __future__ import annotations

import numpy as np


class LineSearchBase:
    def __init__(self, maxsteps: int = 15, alpha: float = 1e-4,
                 low: float = 0.1):
        self.maxsteps = maxsteps
        self.alpha = alpha
        self.low = low

    def search(self, x, norm_f0, p, func, norm_fn):
        """Return (x_new, F_new, norm_new, ok)."""
        raise NotImplementedError


class TrivialLinesearch(LineSearchBase):
    """Always take the full Newton step (reference LineSearch.py:40-52)."""

    def search(self, x, norm_f0, p, func, norm_fn):
        x_new = x + p
        F_new = func.evalF(x_new)
        return x_new, F_new, float(norm_fn(F_new)), True


class SimpleBacktrack(LineSearchBase):
    """Backtracking with sufficient-decrease (reference LineSearch.py:55-81)."""

    def search(self, x, norm_f0, p, func, norm_fn):
        t = 1.0
        norm_f0 = float(norm_f0)
        F_new = None
        for _ in range(self.maxsteps):
            x_new = x + t * p
            F_new = func.evalF(x_new)
            norm_new = float(norm_fn(F_new))
            if np.isfinite(norm_new) and \
                    norm_new <= (1.0 - self.alpha * t) * norm_f0:
                return x_new, F_new, norm_new, True
            ratio = norm_new / norm_f0 if norm_f0 > 0 else 2.0
            shrink = 0.5 / ratio if np.isfinite(ratio) and ratio > 0 else 0.5
            t *= float(np.clip(shrink, self.low, 0.5))
        # all trials rejected: last F_new is from a rejected point — the
        # caller aborts on ok=False and only uses the norm, so return it
        # without re-evaluating F at the unchanged x (an extra device
        # residual evaluation)
        return x, F_new, norm_f0, False
