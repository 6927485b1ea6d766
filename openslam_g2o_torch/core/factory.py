"""The marginalizing LM of the algorithm factory: `_SchurAuto`.

Counterpart of `_SchurAuto` (openslam_g2o_tpu/core/factory.py:41-76), what
the reference's `-solver lm_fix6_3` (with marginalization) constructs
(solver_csparse.cpp:104-124). The name grammar and `construct_algorithm`
are not ported yet (ROADMAP.md queue 1, with Dogleg).

Routing: the dual-ELL solver (core/ba_ell.py) where its pattern builds,
else the general Schur path (core/ba.py). The JAX class falls back on
ValueError only (a non-binary landmark edge). The port's dual-ELL pattern
also raises NotImplementedError, for a second pose group and for block
widths outside its kernels' instantiations ((6, 3), (3, 2) and the BAL
camera's (9, 3)), where the JAX dual-ELL solver runs; `_SchurAuto` falls
back on both, so such binary graphs take the general path here (ROADMAP.md
queue 3, "route difference"). A BAL graph goes to the dual-ELL solver, as
in JAX; the general path takes it too ((9, 3) is one of K14's
instantiations) when a caller asks for LevenbergMarquardtSchur.
"""
from __future__ import annotations

import inspect

from openslam_g2o_torch.core.ba import LevenbergMarquardtSchur
from openslam_g2o_torch.core.ba_ell import (
    LevenbergMarquardtSchurELL, build_ba_ell_pattern)

__all__ = ["_SchurAuto"]


class _SchurAuto:
    """Marginalizing LM: the scatter-free dual-ELL solver when the problem
    is BA-shaped (binary projection edges, one pose group, widths the ELL
    kernels serve), else the general Schur path. `impl` is the chosen
    algorithm after `init`."""

    name = "lm_schur"

    def __init__(self, **props):
        self._props = props
        self.impl = None

    @staticmethod
    def _filter_props(ctor, props):
        accepted = set(inspect.signature(ctor.__init__).parameters)
        return {k: v for k, v in props.items() if k in accepted}

    def _resolve(self, prob):
        if self.impl is None:
            try:
                build_ba_ell_pattern(prob)
                self.impl = LevenbergMarquardtSchurELL(
                    **self._filter_props(LevenbergMarquardtSchurELL,
                                         self._props))
            except (ValueError, NotImplementedError):
                self.impl = LevenbergMarquardtSchur(
                    **self._filter_props(LevenbergMarquardtSchur,
                                         self._props))
        return self.impl

    def init(self, prob):
        return self._resolve(prob).init(prob)

    def step(self, prob, state):
        return self.impl.step(prob, state)
