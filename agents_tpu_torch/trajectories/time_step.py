"""TimeStep / StepType: the environment-output data model.

Port of ``agents_tpu/trajectories/time_step.py``. `TimeStep` is a frozen
dataclass, a node of the port's nests (`utils.nest_utils`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from agents_tpu_torch.specs import array_spec


class StepType:
  """FIRST/MID/LAST markers."""
  FIRST = 0
  MID = 1
  LAST = 2


@dataclasses.dataclass(frozen=True)
class TimeStep:
  """(step_type, reward, discount, observation)."""
  step_type: Any
  reward: Any
  discount: Any
  observation: Any

  def is_first(self):
    return self.step_type == StepType.FIRST

  def is_last(self):
    return self.step_type == StepType.LAST

  def replace(self, **kwargs) -> "TimeStep":
    return dataclasses.replace(self, **kwargs)


def restart(observation: torch.Tensor, batch_size: Optional[int] = None
            ) -> TimeStep:
  """FIRST step with zero reward and unit discount."""
  outer = (batch_size,) if batch_size is not None else ()
  device = observation.device
  return TimeStep(
      step_type=torch.full(outer, StepType.FIRST, dtype=torch.int32,
                           device=device),
      reward=torch.zeros(outer, dtype=torch.float32, device=device),
      discount=torch.ones(outer, dtype=torch.float32, device=device),
      observation=observation)


def time_step_spec(observation_spec, reward_spec=None) -> TimeStep:
  """Spec nest for TimeSteps given observation/reward specs."""
  if reward_spec is None:
    reward_spec = array_spec.ArraySpec((), np.float32, name="reward")
  return TimeStep(
      step_type=array_spec.ArraySpec((), np.int32, name="step_type"),
      reward=reward_spec,
      discount=array_spec.BoundedArraySpec(
          (), np.float32, minimum=0.0, maximum=1.0, name="discount"),
      observation=observation_spec)
