"""Model registry of the port: the six systems of timeopt_tpu/models, in the
same order, and the port's own 6-DoF powered-descent lander (Rocket6DoF,
14 states, 3 inputs). Each has a `device_id` naming its dynamics (and, for
PointMass, its obstacle penalty) in the line-search and Jacobian kernels,
csrc/systems.cuh."""

from timeopt_tpu_torch.models import ballbot, cartpole, double_integrator, pointmass, quadrotor, rocket6dof, segway
from timeopt_tpu_torch.models.base import Problem, System, make_problem, problem_from_numpy

_MODULES = (double_integrator, cartpole, quadrotor, segway, ballbot, pointmass, rocket6dof)

SYSTEMS = {mod.SYSTEM.name: mod for mod in _MODULES}


def get_system(name: str):
    """Return (System, default_problem_factory) for a registered model."""
    if name not in SYSTEMS:
        raise KeyError(f"unknown system {name!r}; available: {sorted(SYSTEMS)}")
    mod = SYSTEMS[name]
    return mod.SYSTEM, mod.default_problem


__all__ = ["Problem", "System", "make_problem", "problem_from_numpy", "SYSTEMS", "get_system"]
