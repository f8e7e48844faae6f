"""Model registry of the port: the quadrotor and the double integrator.
The other models of timeopt_tpu/models are not ported yet (ROADMAP.md)."""

from timeopt_tpu_torch.models import double_integrator, quadrotor
from timeopt_tpu_torch.models.base import Problem, System, make_problem, problem_from_numpy

_MODULES = (double_integrator, quadrotor)

SYSTEMS = {mod.SYSTEM.name: mod for mod in _MODULES}


def get_system(name: str):
    """Return (System, default_problem_factory) for a registered model."""
    if name not in SYSTEMS:
        raise KeyError(f"unknown system {name!r}; available in the port: {sorted(SYSTEMS)}")
    mod = SYSTEMS[name]
    return mod.SYSTEM, mod.default_problem


__all__ = ["Problem", "System", "make_problem", "problem_from_numpy", "SYSTEMS", "get_system"]
