"""MountainCar, discrete and continuous, as batched on-device environments.

Port of ``agents_tpu/environments/classic/mountain_car.py``: Gym's
``MountainCar-v0`` (three actions: push left, none, right; -1 a step; 200
steps) and ``MountainCarContinuous-v0`` (a force in [-1, 1]; 100 at the
goal less ``0.1 a²`` of the raw action a step; 999 steps), in float32
over [B] rows. The observation is ``[position, velocity]``. Reaching the
goal terminates (LAST, discount 0.0); the time limit truncates (LAST,
discount 1.0).

Draw site (reset): "mountain_car_position", uniform [B] in [-0.6, -0.4);
the velocity starts at 0. The step is deterministic, its arithmetic in the
JAX package's order.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from agents_tpu_torch.environments.torch_environment import TorchEnvironment
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts

_MIN_POS = -1.2
_MAX_POS = 0.6
_MAX_SPEED = 0.07
_GOAL_POS = 0.5
_FORCE = 0.001
_GRAVITY = 0.0025

_C_GOAL_POS = 0.45
_C_POWER = 0.0015


@dataclasses.dataclass(frozen=True)
class MountainCarState:
  physics: torch.Tensor     # [B, 2] float32: position, velocity
  steps: torch.Tensor       # [B] int32
  terminated: torch.Tensor  # [B] bool


def _observation_spec():
  return array_spec.BoundedArraySpec(
      (2,), np.float32, minimum=np.array([_MIN_POS, -_MAX_SPEED], np.float32),
      maximum=np.array([_MAX_POS, _MAX_SPEED], np.float32),
      name="observation")


def _reset(draws, batch_size):
  pos = draws.uniform("mountain_car_position", (batch_size,), -0.6, -0.4)
  physics = torch.stack([pos, torch.zeros_like(pos)], dim=-1)
  device = pos.device
  state = MountainCarState(
      physics=physics,
      steps=torch.zeros((batch_size,), dtype=torch.int32, device=device),
      terminated=torch.zeros((batch_size,), dtype=torch.bool, device=device))
  return state, ts.restart(physics, batch_size)


def _advance(state, pos, vel, goal, max_episode_steps, reward_of):
  """Clip, stop at the left wall, and emit the time step."""
  vel = torch.clamp(vel, -_MAX_SPEED, _MAX_SPEED)
  pos = torch.clamp(pos + vel, _MIN_POS, _MAX_POS)
  vel = torch.where((pos <= _MIN_POS) & (vel < 0.0), 0.0, vel)
  physics = torch.stack([pos, vel], dim=-1)
  steps = state.steps + 1
  terminated = (pos >= goal) & (vel >= 0.0)
  done = terminated | (steps >= max_episode_steps)
  step_type = torch.where(done, ts.StepType.LAST,
                          ts.StepType.MID).to(torch.int32)
  discount = torch.where(terminated, 0.0, 1.0).to(torch.float32)
  new_state = MountainCarState(physics=physics, steps=steps,
                               terminated=terminated)
  return new_state, ts.TimeStep(step_type=step_type,
                                reward=reward_of(terminated),
                                discount=discount, observation=physics)


class MountainCar(TorchEnvironment):
  """Discrete 3-action mountain car; max_episode_steps=200 mirrors v0."""

  def __init__(self, max_episode_steps: int = 200):
    self.max_episode_steps = max_episode_steps

  def observation_spec(self):
    return _observation_spec()

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0, 2, name="action")

  def reset(self, draws, batch_size: int):
    return _reset(draws, batch_size)

  def step(self, state: MountainCarState, action, draws=None):
    del draws
    pos, vel = state.physics.unbind(-1)
    vel = vel + (action.to(torch.float32) - 1.0) * _FORCE + torch.cos(
        3.0 * pos) * (-_GRAVITY)
    return _advance(state, pos, vel, _GOAL_POS, self.max_episode_steps,
                    lambda terminated: torch.full_like(pos, -1.0))


class ContinuousMountainCar(TorchEnvironment):
  """Continuous-action mountain car; max_episode_steps=999 mirrors v0."""

  def __init__(self, max_episode_steps: int = 999):
    self.max_episode_steps = max_episode_steps

  def observation_spec(self):
    return _observation_spec()

  def action_spec(self):
    return array_spec.BoundedArraySpec((1,), np.float32, -1.0, 1.0,
                                       name="action")

  def reset(self, draws, batch_size: int):
    return _reset(draws, batch_size)

  def step(self, state: MountainCarState, action, draws=None):
    del draws
    pos, vel = state.physics.unbind(-1)
    force = torch.clamp(action[:, 0], -1.0, 1.0)
    vel = vel + force * _C_POWER - 0.0025 * torch.cos(3.0 * pos)
    # The penalty takes the raw action: an action out of bounds is clipped
    # for the dynamics but pays in full.
    return _advance(
        state, pos, vel, _C_GOAL_POS, self.max_episode_steps,
        lambda terminated: (torch.where(terminated, 100.0, 0.0)
                            - 0.1 * action[:, 0]**2).to(torch.float32))
