"""CartPole as a batched on-device environment.

Port of ``agents_tpu/environments/classic/cartpole.py``: Gym's classic
``CartPole-v0/v1`` dynamics in float32 over [B] rows. Time-limit truncation
emits LAST with discount 1.0; pole-fall termination emits LAST with
discount 0.0. `sin`/`cos` and the squares may differ from XLA's by an ulp.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from agents_tpu_torch.environments.torch_environment import TorchEnvironment
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts

_GRAVITY = 9.8
_MASS_CART = 1.0
_MASS_POLE = 0.1
_TOTAL_MASS = _MASS_CART + _MASS_POLE
_LENGTH = 0.5  # half pole length
_POLEMASS_LENGTH = _MASS_POLE * _LENGTH
_FORCE_MAG = 10.0
_TAU = 0.02
_THETA_THRESHOLD = 12 * 2 * math.pi / 360
_X_THRESHOLD = 2.4


@dataclasses.dataclass(frozen=True)
class CartPoleState:
  physics: torch.Tensor     # [B, 4] float32: x, x_dot, theta, theta_dot
  steps: torch.Tensor       # [B] int32
  terminated: torch.Tensor  # [B] bool: pole fell / out of bounds last step


class CartPole(TorchEnvironment):
  """max_episode_steps=200 mirrors CartPole-v0; pass 500 for v1."""

  def __init__(self, max_episode_steps: int = 200):
    self.max_episode_steps = max_episode_steps

  def observation_spec(self):
    return array_spec.BoundedArraySpec(
        (4,), np.float32,
        minimum=np.array([-4.8, np.finfo(np.float32).min, -0.418,
                          np.finfo(np.float32).min], np.float32),
        maximum=np.array([4.8, np.finfo(np.float32).max, 0.418,
                          np.finfo(np.float32).max], np.float32),
        name="observation")

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0, 1, name="action")

  def reset(self, draws, batch_size: int):
    physics = draws.uniform("env_reset", (batch_size, 4), -0.05, 0.05)
    device = physics.device
    state = CartPoleState(
        physics=physics,
        steps=torch.zeros((batch_size,), dtype=torch.int32, device=device),
        terminated=torch.zeros((batch_size,), dtype=torch.bool,
                               device=device))
    return state, ts.restart(physics, batch_size)

  def step(self, state: CartPoleState, action, draws=None):
    del draws  # deterministic dynamics
    x, x_dot, theta, theta_dot = state.physics.unbind(-1)
    force = torch.where(action == 1, _FORCE_MAG, -_FORCE_MAG).to(x.dtype)
    costheta = torch.cos(theta)
    sintheta = torch.sin(theta)
    temp = (force + _POLEMASS_LENGTH * theta_dot**2 * sintheta) / _TOTAL_MASS
    thetaacc = (_GRAVITY * sintheta - costheta * temp) / (
        _LENGTH * (4.0 / 3.0 - _MASS_POLE * costheta**2 / _TOTAL_MASS))
    xacc = temp - _POLEMASS_LENGTH * thetaacc * costheta / _TOTAL_MASS

    x = x + _TAU * x_dot
    x_dot = x_dot + _TAU * xacc
    theta = theta + _TAU * theta_dot
    theta_dot = theta_dot + _TAU * thetaacc
    physics = torch.stack([x, x_dot, theta, theta_dot], dim=-1)

    steps = state.steps + 1
    terminated = (x.abs() > _X_THRESHOLD) | (theta.abs() > _THETA_THRESHOLD)
    done = terminated | (steps >= self.max_episode_steps)

    step_type = torch.where(done, ts.StepType.LAST,
                            ts.StepType.MID).to(torch.int32)
    discount = torch.where(terminated, 0.0, 1.0).to(torch.float32)
    new_state = CartPoleState(physics=physics, steps=steps,
                              terminated=terminated)
    return new_state, ts.TimeStep(
        step_type=step_type, reward=torch.ones_like(x), discount=discount,
        observation=physics)
