"""Rollout collection: the step driver and the exact-episode driver.

Port of ``agents_tpu/drivers/jax_driver.py`` (`JaxDriver`,
`JaxEpisodeDriver`). `lax.scan` becomes a Python loop over device tensors.
Observers are pure reducers ``(observer_state, trajectory_frame) ->
observer_state`` (replay `add_batch`, metric `update`); boundary frames
(LAST -> FIRST after auto-reset) reach them, as in the JAX package. The
policy and the env run under `torch.no_grad`. With `return_trajectories`,
`TorchDriver.run` also returns the ``[T, B, ...]`` stack of its frames;
distributions in `policy_info` stack leaf by leaf (their static fields
pass through).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from agents_tpu_torch.environments.torch_environment import BatchedTorchEnv
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import nest_utils


@dataclasses.dataclass(frozen=True)
class DriverState:
  env_state: Any
  time_step: ts.TimeStep
  policy_state: Any


class _DriverBase:

  def __init__(self, env: BatchedTorchEnv, policy,
               observers: Sequence[Callable] = ()):
    self.env = env
    self.policy = policy
    self.observers = tuple(observers)

  def init(self, draws) -> DriverState:
    env_state, time_step = self.env.reset(draws)
    policy_state = self.policy.init_state(self.env.batch_size,
                                          device=self.env.device)
    return DriverState(env_state=env_state, time_step=time_step,
                       policy_state=policy_state)

  def _step(self, params, dstate: DriverState, draws):
    """One lockstep step: (next driver state, trajectory frame)."""
    action_step = self.policy.action(params, dstate.time_step,
                                     dstate.policy_state, draws)
    env_state, next_time_step = self.env.step(
        dstate.env_state, dstate.time_step, action_step.action, draws)
    frame = tj.from_transition(dstate.time_step, action_step, next_time_step)
    return DriverState(env_state=env_state, time_step=next_time_step,
                       policy_state=action_step.state), frame


class TorchDriver(_DriverBase):
  """Collects `num_steps` lockstep frames per `run` (each step emits one
  frame per env row, boundary frames included)."""

  def __init__(self, env: BatchedTorchEnv, policy,
               observers: Sequence[Callable] = (),
               return_trajectories: bool = False):
    super().__init__(env, policy, observers)
    self.return_trajectories = return_trajectories

  @torch.no_grad()
  def run(self, params, state: DriverState, observer_states, draws,
          num_steps: int):
    """Returns (state, observer_states[, trajectories [T, B, ...]])."""
    observer_states = tuple(observer_states)
    frames = []
    for _ in range(num_steps):
      state, frame = self._step(params, state, draws)
      observer_states = tuple(
          obs(s, frame) for obs, s in zip(self.observers, observer_states))
      if self.return_trajectories:
        frames.append(frame)
    if self.return_trajectories:
      return state, observer_states, nest_utils.stack_nested_tensors(frames)
    return state, observer_states


def _mask_frame(frame: tj.Trajectory, valid: torch.Tensor) -> tj.Trajectory:
  """Rewrite the rows that filled their quota as boundary frames with zero
  reward and discount, which every standard metric ignores."""
  return frame.replace(
      step_type=torch.where(valid, frame.step_type, ts.StepType.LAST).to(
          frame.step_type.dtype),
      next_step_type=torch.where(valid, frame.next_step_type,
                                 ts.StepType.MID).to(
                                     frame.next_step_type.dtype),
      reward=torch.where(valid, frame.reward, 0.0),
      discount=torch.where(valid, frame.discount, 0.0))


class TorchEpisodeDriver(_DriverBase):
  """Runs until exactly `num_episodes` episodes have completed.

  Episode quotas are spread over the rows (row i gets
  ``num_episodes // B`` plus one of the remainder); once a row has filled
  its quota its frames are masked as boundary frames before they reach the
  observers, so the metrics see exactly `num_episodes` episodes. The JAX
  package's `while_loop` checks its condition on the device every step;
  here the host reads it every `CHECK_EVERY` steps (one sync each), and
  the up to `CHECK_EVERY - 1` steps run past the last quota are wholly
  masked, so they change no metric.
  """

  CHECK_EVERY = 32

  def _quotas(self, num_episodes: int) -> torch.Tensor:
    b = self.env.batch_size
    base, rem = divmod(num_episodes, b)
    return base + (torch.arange(b, device=self.env.device) < rem).to(
        torch.int64)

  @torch.no_grad()
  def run(self, params, state: DriverState, observer_states, draws,
          num_episodes: int, max_steps: int = 10_000):
    """Returns (state, observer_states, steps_taken, episodes_completed),
    the last two as host ints. `episodes_completed < num_episodes` means
    `max_steps` ran out first."""
    quotas = self._quotas(num_episodes)
    completed = torch.zeros_like(quotas)
    observer_states = tuple(observer_states)
    steps = 0
    while steps < max_steps and bool((completed < quotas).any()):
      for _ in range(min(self.CHECK_EVERY, max_steps - steps)):
        state, frame = self._step(params, state, draws)
        valid = completed < quotas
        masked = _mask_frame(frame, valid)
        observer_states = tuple(
            obs(s, masked) for obs, s in zip(self.observers, observer_states))
        completed = completed + (frame.is_last() & valid).to(torch.int64)
        steps += 1
    episodes_completed = int(torch.minimum(completed, quotas).sum())
    return state, observer_states, steps, episodes_completed
