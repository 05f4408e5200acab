"""Thread-batched host environments.

Port of ``agents_tpu/environments/batched_py_environment.py``: N
PyEnvironments stepped as one batched env on a thread pool (C simulators
such as MuJoCo release the GIL, so their instances step in parallel).
Each row auto-resets on its own.
"""
from __future__ import annotations

from concurrent import futures
from typing import Sequence

import numpy as np

from agents_tpu_torch.environments.py_environment import PyEnvironment
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import nest_utils


class BatchedPyEnvironment(PyEnvironment):

  def __init__(self, envs: Sequence[PyEnvironment],
               multithreading: bool = True):
    super().__init__()
    if not envs:
      raise ValueError("Need at least one environment")
    self._envs = list(envs)
    spec = envs[0].observation_spec()
    for e in envs[1:]:
      if e.observation_spec() != spec and \
          repr(e.observation_spec()) != repr(spec):
        raise ValueError("All envs must share observation specs")
    self._pool = (futures.ThreadPoolExecutor(max_workers=len(envs))
                  if multithreading and len(envs) > 1 else None)

  @property
  def batched(self):
    return True

  @property
  def batch_size(self):
    return len(self._envs)

  @property
  def envs(self):
    return self._envs

  def observation_spec(self):
    return self._envs[0].observation_spec()

  def action_spec(self):
    return self._envs[0].action_spec()

  def reward_spec(self):
    return self._envs[0].reward_spec()

  def _execute(self, fn, iterable):
    if self._pool is None:
      return [fn(x) for x in iterable]
    return list(self._pool.map(fn, iterable))

  def _reset(self):
    return nest_utils.stack_nested_arrays(
        self._execute(lambda e: e.reset(), self._envs))

  def _step(self, actions):
    rows = [nest_utils.tree_map(lambda x: np.asarray(x)[i], actions)
            for i in range(len(self._envs))]
    steps = self._execute(lambda ea: ea[0].step(ea[1]),
                          list(zip(self._envs, rows)))
    return nest_utils.stack_nested_arrays(steps)

  def step(self, action) -> ts.TimeStep:
    """Steps every row; a row whose current step is LAST resets alone (its
    own env's auto-reset), where the base class checks all rows."""
    if self._current_time_step is None:
      return self.reset()
    self._current_time_step = self._step(action)
    return self._current_time_step

  def seed(self, seeds):
    """One seed per row; a scalar seed s gives rows s, s + 1, ...: one
    seed for every row would collapse the batch to one env's data."""
    if np.ndim(seeds) == 0:
      seeds = int(seeds) + np.arange(len(self._envs))
    seeds = np.asarray(seeds)
    if seeds.shape != (len(self._envs),):
      raise ValueError(f"need {len(self._envs)} seeds, got {seeds.shape}")
    return self._execute(lambda es: es[0].seed(int(es[1])),
                         list(zip(self._envs, seeds)))

  def close(self):
    self._execute(lambda e: e.close(), self._envs)
    if self._pool:
      self._pool.shutdown()
