"""Host-side (numpy) environment base.

Port of ``agents_tpu/environments/py_environment.py``: `PyEnvironment`
with the auto-reset protocol (stepping a LAST time step ignores the
action and restarts, unless `handle_auto_reset` is False) and the numpy
time-step factories `np_restart`, `np_transition`, `np_termination` and
`np_truncation`. Host environments carry the C/C++ simulators (MuJoCo,
gymnasium's control tasks) that cannot run on the card; their time steps
are numpy nests, and the host loops copy them to the device.
"""
from __future__ import annotations

import abc
from typing import Optional

import numpy as np

from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts


def np_restart(observation, batch_size=None, reward_spec=None) -> ts.TimeStep:
  """FIRST step: zero reward (of `reward_spec`'s nest when given), unit
  discount."""
  outer = (batch_size,) if batch_size is not None else ()
  if reward_spec is None:
    reward = np.zeros(outer, np.float32)
  else:
    reward = array_spec.map_spec_nest(
        lambda s: np.zeros(outer + s.shape, s.dtype), reward_spec)
  return ts.TimeStep(step_type=np.full(outer, ts.StepType.FIRST, np.int32),
                     reward=reward, discount=np.ones(outer, np.float32),
                     observation=observation)


def _np_step(step_type, observation, reward, discount) -> ts.TimeStep:
  reward = np.asarray(reward)
  return ts.TimeStep(
      step_type=np.full(reward.shape, step_type, np.int32), reward=reward,
      discount=np.broadcast_to(np.asarray(discount, np.float32),
                               reward.shape).copy(),
      observation=observation)


def np_transition(observation, reward, discount=1.0) -> ts.TimeStep:
  return _np_step(ts.StepType.MID, observation, reward, discount)


def np_termination(observation, reward) -> ts.TimeStep:
  return _np_step(ts.StepType.LAST, observation, reward, 0.0)


def np_truncation(observation, reward, discount=1.0) -> ts.TimeStep:
  return _np_step(ts.StepType.LAST, observation, reward, discount)


class PyEnvironment(abc.ABC):
  """reset / step / current_time_step, the batched properties, and the
  optional render / seed / close / get_state / set_state surface."""

  def __init__(self, handle_auto_reset: bool = True):
    # handle_auto_reset=False leaves stepping past LAST to the caller (a
    # manual reset), e.g. GymWrapper(auto_reset=False) for eval loops that
    # count episodes by reset().
    self._current_time_step: Optional[ts.TimeStep] = None
    self._handle_auto_reset = handle_auto_reset

  @property
  def batched(self) -> bool:
    return False

  @property
  def batch_size(self) -> Optional[int]:
    return None

  @abc.abstractmethod
  def observation_spec(self):
    ...

  @abc.abstractmethod
  def action_spec(self):
    ...

  def reward_spec(self):
    return array_spec.ArraySpec((), np.float32, name="reward")

  def time_step_spec(self):
    return ts.time_step_spec(self.observation_spec(), self.reward_spec())

  def current_time_step(self) -> ts.TimeStep:
    if self._current_time_step is None:
      return self.reset()
    return self._current_time_step

  def reset(self) -> ts.TimeStep:
    self._current_time_step = self._reset()
    return self._current_time_step

  def step(self, action) -> ts.TimeStep:
    if self._current_time_step is None:
      return self.reset()
    if getattr(self, "_handle_auto_reset", True) and np.all(
        self._current_time_step.step_type == ts.StepType.LAST):
      return self.reset()
    self._current_time_step = self._step(action)
    return self._current_time_step

  @abc.abstractmethod
  def _reset(self) -> ts.TimeStep:
    ...

  @abc.abstractmethod
  def _step(self, action) -> ts.TimeStep:
    ...

  def render(self, mode="rgb_array"):
    raise NotImplementedError

  def seed(self, seed):
    raise NotImplementedError

  def close(self):
    pass

  def get_state(self):
    raise NotImplementedError

  def set_state(self, state):
    raise NotImplementedError

  def get_info(self):
    return None

  def __enter__(self):
    return self

  def __exit__(self, *args):
    self.close()
