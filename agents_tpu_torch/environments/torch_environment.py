"""Batched on-device environments with lockstep auto-reset.

Port of ``agents_tpu/environments/jax_environment.py``. The JAX package
writes each env for one instance and `vmap`s it; here an environment is
written for a leading batch dim directly: ``reset(draws, batch_size)`` and
``step(state, action, draws)`` act on [B, ...] tensors.

Auto-reset follows the JAX package (`BatchedJaxEnv.step`, :100-126): both
branches are computed for every row, then selected with `where` on
``prev_time_step.is_last()``. The action given on a LAST step is discarded,
and reset draws are made for all B rows on every step.
"""
from __future__ import annotations

import abc
from typing import Any, Tuple

import numpy as np

from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device


class TorchEnvironment(abc.ABC):
  """Batched functional environment over [B, ...] tensors."""

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

  @abc.abstractmethod
  def reset(self, draws, batch_size: int) -> Tuple[Any, ts.TimeStep]:
    """Start B new episodes on `draws.device`: (env_state, FIRST steps)."""

  @abc.abstractmethod
  def step(self, state, action, draws) -> Tuple[Any, ts.TimeStep]:
    """Advance every row one step, no auto-reset."""


class BatchedTorchEnv:
  """B lockstep instances of a `TorchEnvironment` with auto-reset on LAST.

  Args:
    env: the environment.
    batch_size: number of rows B.
    device: where the rows live; "cuda" unless the caller asks for "cpu".
  """

  def __init__(self, env: TorchEnvironment, batch_size: int, device="cuda"):
    self.env = env
    self.batch_size = int(batch_size)
    self.device = resolve_device(device)

  def observation_spec(self):
    return self.env.observation_spec()

  def action_spec(self):
    return self.env.action_spec()

  def reward_spec(self):
    return self.env.reward_spec()

  def time_step_spec(self):
    return self.env.time_step_spec()

  def reset(self, draws):
    return self.env.reset(draws, self.batch_size)

  def step(self, state, prev_time_step: ts.TimeStep, action, draws):
    """Lockstep step; rows whose previous step was LAST restart instead.

    Returns (new_state, new_time_step).
    """
    stepped_state, stepped_ts = self.env.step(state, action, draws)
    reset_state, reset_ts = self.env.reset(draws, self.batch_size)
    needs_reset = prev_time_step.is_last()
    new_state = nest_utils.where(needs_reset, reset_state, stepped_state)
    new_ts = nest_utils.where(needs_reset, reset_ts, stepped_ts)
    return new_state, new_ts
