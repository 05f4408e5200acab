"""TimeStep / StepType: the environment-output data model.

Port of ``agents_tpu/trajectories/time_step.py``: `TimeStep`, `restart`,
`transition`, `termination`, `truncation` and `time_step_spec`. `TimeStep`
is a frozen dataclass, a node of the port's nests (`utils.nest_utils`);
its leaves are tensors on the device paths and numpy arrays on the host
(`environments/py_environment.py` builds those).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils


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

  def is_mid(self):
    return self.step_type == StepType.MID

  def is_last(self):
    return self.step_type == StepType.LAST

  def replace(self, **kwargs) -> "TimeStep":
    return dataclasses.replace(self, **kwargs)


def _reward_like(reward_spec, outer, device):
  """Zero rewards of `reward_spec`'s nest under `outer` (a float32 scalar
  per row when there is no spec)."""
  if reward_spec is None:
    return torch.zeros(outer, dtype=torch.float32, device=device)
  return array_spec.zero_spec_nest(reward_spec, outer_dims=outer,
                                   device=device)


def restart(observation, batch_size: Optional[int] = None,
            reward_spec=None) -> TimeStep:
  """FIRST step with zero reward (zeros of `reward_spec`'s nest and
  shapes when given) and unit discount, on the observation's device."""
  outer = (batch_size,) if batch_size is not None else ()
  device = nest_utils.flatten(observation)[0].device
  return TimeStep(
      step_type=torch.full(outer, StepType.FIRST, dtype=torch.int32,
                           device=device),
      reward=_reward_like(reward_spec, outer, device),
      discount=torch.ones(outer, dtype=torch.float32, device=device),
      observation=observation)


def _step(step_type, observation, reward, discount, outer_dims):
  """A TimeStep of `step_type` whose discount broadcasts over the outer
  dims (the first reward leaf's shape when None), on its device."""
  reward = nest_utils.tree_map(torch.as_tensor, reward)
  first = nest_utils.flatten(reward)[0]
  outer = tuple(first.shape) if outer_dims is None else tuple(outer_dims)
  return TimeStep(
      step_type=torch.full(outer, step_type, dtype=torch.int32,
                           device=first.device),
      reward=reward,
      discount=torch.as_tensor(discount, dtype=torch.float32,
                               device=first.device).expand(outer).clone(),
      observation=observation)


def transition(observation, reward, discount=1.0, outer_dims=None
               ) -> TimeStep:
  """MID step."""
  return _step(StepType.MID, observation, reward, discount, outer_dims)


def termination(observation, reward, outer_dims=None) -> TimeStep:
  """LAST step with zero discount."""
  return _step(StepType.LAST, observation, reward, 0.0, outer_dims)


def truncation(observation, reward, discount=1.0, outer_dims=None
               ) -> TimeStep:
  """LAST step with a non-zero discount (a time limit)."""
  return _step(StepType.LAST, observation, reward, discount, outer_dims)


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
