"""Deterministic and random host test environments.

Port of ``agents_tpu/environments/test_envs.py``: `CountingPyEnv`
(observation = episode * 10 + step) and `RandomPyEnvironment` (spec-driven
random observations, rewards and episode ends from one
`np.random.RandomState`, drawn in the JAX package's order so both packages
step identically from one seed).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from agents_tpu_torch.environments.py_environment import (PyEnvironment,
                                                          np_restart,
                                                          np_termination,
                                                          np_transition)
from agents_tpu_torch.specs import array_spec


class CountingPyEnv(PyEnvironment):
  """observation = episode * 10 + step; reward 1 per step; episodes of
  `steps_per_episode` steps."""

  def __init__(self, steps_per_episode: int = 3):
    super().__init__()
    self._steps_per_episode = steps_per_episode
    self._episodes = 0
    self._steps = 0

  def observation_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0, 2**28, "obs")

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0, 1, "action")

  def _obs(self):
    return np.asarray(self._episodes * 10 + self._steps, np.int32)

  def _reset(self):
    self._steps = 0
    return np_restart(self._obs())

  def _step(self, action):
    del action
    self._steps += 1
    obs = self._obs()
    if self._steps >= self._steps_per_episode:
      self._episodes += 1
      return np_termination(obs, np.asarray(1.0, np.float32))
    return np_transition(obs, np.asarray(1.0, np.float32))


class RandomPyEnvironment(PyEnvironment):
  """Random observations of `observation_spec` (bounded leaves uniform
  within bounds clipped to +-1e6, integers uniform over the inclusive
  range, unbounded leaves standard normal), rewards uniform in [-1, 1)
  unless `reward_fn` is given, and an episode end with probability
  `episode_end_probability` per step once `min_duration` steps are done
  (always at `max_duration`)."""

  def __init__(self, observation_spec, action_spec,
               episode_end_probability: float = 0.1,
               discount: float = 1.0, reward_fn=None,
               min_duration: int = 0, max_duration: Optional[int] = None,
               seed: int = 42):
    super().__init__()
    self._observation_spec = observation_spec
    self._action_spec = action_spec
    self._p_end = episode_end_probability
    self._discount = discount
    self._reward_fn = reward_fn or (
        lambda: np.asarray(self._rng.uniform(-1, 1), np.float32))
    self._min_duration = min_duration
    self._max_duration = max_duration
    self._rng = np.random.RandomState(seed)
    self._num_steps = 0

  def observation_spec(self):
    return self._observation_spec

  def action_spec(self):
    return self._action_spec

  def _sample_obs(self):
    def _sample(s):
      if isinstance(s, array_spec.BoundedArraySpec):
        if np.issubdtype(s.dtype, np.integer):
          return self._rng.randint(
              s.minimum, np.minimum(np.asarray(s.maximum, np.int64),
                                    2**31 - 2) + 1,
              size=s.shape).astype(s.dtype)
        lo = np.maximum(np.asarray(s.minimum, np.float64), -1e6)
        hi = np.minimum(np.asarray(s.maximum, np.float64), 1e6)
        return self._rng.uniform(lo, hi, size=s.shape).astype(s.dtype)
      return self._rng.randn(*s.shape).astype(s.dtype)

    return array_spec.map_spec_nest_sorted(_sample, self._observation_spec)

  def _reset(self):
    self._num_steps = 0
    return np_restart(self._sample_obs())

  def _step(self, action):
    self._num_steps += 1
    obs = self._sample_obs()
    reward = self._reward_fn()
    ends = self._rng.rand() < self._p_end and \
        self._num_steps >= self._min_duration
    if self._max_duration and self._num_steps >= self._max_duration:
      ends = True
    if ends:
      return np_termination(obs, reward)
    return np_transition(obs, reward, self._discount)

  def seed(self, seed):
    self._rng = np.random.RandomState(seed)
