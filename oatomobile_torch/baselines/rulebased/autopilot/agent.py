"""PID-controller-based autopilot agent for the single-scene API: port of
the JAX package's ``baselines/rulebased/autopilot/agent.py``.

The decision logic is the port's batched expert (``sim/autopilot.py``);
this class is the host-side ``Agent`` adapter for single-scene gym loops:
it reads the simulator's scene (a batch of one on the simulator's
device), runs one policy evaluation and writes the updated PID/RNG state
back, so the controller's integrals stay continuous across steps.  The
evaluation is the simulator's captured step of this agent
(``CUDASimulator.captured_step``), as the JAX agent jits its policy.
"""

import numpy as np
import torch

import oatomobile_torch
from oatomobile_torch.sim.autopilot import autopilot_policy
from oatomobile_torch.sim.types import copy_state_
from oatomobile_torch.simulators.cuda import defaults
from oatomobile_torch.simulators.cuda.simulator import CARLAAction


class AutopilotAgent(oatomobile_torch.Agent):
  """An autopilot agent driving toward the environment's destination."""

  def __init__(self,
               environment: oatomobile_torch.Env,
               *,
               proximity_tlight_threshold: float = 5.0,
               proximity_vehicle_threshold: float = 10.0,
               noise: float = 0.1) -> None:
    """Args mirror the reference's; ``noise`` is the probability of a
    uniformly random action.  The expert's target speed is the reference's
    ``defaults.TARGET_SPEED`` (20 km/h)."""
    super().__init__(environment=environment)
    self._sim = self._environment.unwrapped.simulator
    self._noise = noise
    # Thresholds live in WorldParams; override them for this agent.
    params = self._sim.params

    def f32(value):
      return torch.tensor(np.float32(value), dtype=torch.float32,
                          device=params.device)

    self._params = params.replace(
        proximity_vehicle_threshold=f32(proximity_vehicle_threshold),
        proximity_tlight_threshold=f32(proximity_tlight_threshold))

  def _policy(self, state):
    """The action [1, 3]; the PID, patience and key written back."""
    action, new_state = autopilot_policy(
        self._params, state, noise=self._noise,
        target_speed=defaults.TARGET_SPEED / 3.6)
    copy_state_(state, new_state)
    return action

  def act(self, observation: oatomobile_torch.Observations,
          *args, **kwargs) -> oatomobile_torch.Action:
    del observation  # The expert reads privileged simulator state.
    a = self._sim.captured_step(self, self._policy)[0].cpu().numpy()
    return CARLAAction(throttle=float(a[0]), steer=float(a[1]),
                       brake=float(a[2]))
