"""Acrobot as a batched on-device environment.

Port of ``agents_tpu/environments/classic/acrobot.py``: Gym's
``Acrobot-v1`` (Sutton's two-link acrobot with the book's dynamics,
integrated by one RK4 step of 0.2 s) in float32 over [B] rows. The
observation is ``[cos θ1, sin θ1, cos θ2, sin θ2, θ̇1, θ̇2]``, the action
one of three torques {-1, 0, +1}. Raising the free end above the bar
terminates (LAST, discount 0.0, reward 0); every other step pays -1, and
after `max_episode_steps` the episode is truncated (LAST, discount 1.0).

Draw site (reset): "acrobot_physics", uniform [B, 4] in [-0.1, 0.1) for
``(θ1, θ2, θ̇1, θ̇2)``. The step is deterministic.

The arithmetic keeps the JAX package's order, term by term; `sin`/`cos`
may differ from XLA's by an ulp, which the chaotic swing amplifies over an
episode.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from agents_tpu_torch.environments.torch_environment import TorchEnvironment
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts

_DT = 0.2
_L1 = 1.0
_M1 = 1.0
_M2 = 1.0
_LC1 = 0.5
_LC2 = 0.5
_I1 = 1.0
_I2 = 1.0
_G = 9.8
_MAX_VEL_1 = 4 * np.pi
_MAX_VEL_2 = 9 * np.pi


@dataclasses.dataclass(frozen=True)
class AcrobotState:
  physics: torch.Tensor     # [B, 4] float32: θ1, θ2, θ̇1, θ̇2
  steps: torch.Tensor       # [B] int32
  terminated: torch.Tensor  # [B] bool


def _wrap(x, lo, hi):
  return lo + torch.remainder(x - lo, hi - lo)


def _dsdt(s_aug):
  theta1, theta2, dtheta1, dtheta2, a = s_aug.unbind(-1)
  d1 = (_M1 * _LC1**2 + _M2 *
        (_L1**2 + _LC2**2 + 2 * _L1 * _LC2 * torch.cos(theta2)) + _I1 + _I2)
  d2 = _M2 * (_LC2**2 + _L1 * _LC2 * torch.cos(theta2)) + _I2
  phi2 = _M2 * _LC2 * _G * torch.cos(theta1 + theta2 - np.pi / 2.0)
  phi1 = (-_M2 * _L1 * _LC2 * dtheta2**2 * torch.sin(theta2)
          - 2 * _M2 * _L1 * _LC2 * dtheta2 * dtheta1 * torch.sin(theta2)
          + (_M1 * _LC1 + _M2 * _L1) * _G * torch.cos(theta1 - np.pi / 2.0)
          + phi2)
  ddtheta2 = ((a + d2 / d1 * phi1
               - _M2 * _L1 * _LC2 * dtheta1**2 * torch.sin(theta2) - phi2)
              / (_M2 * _LC2**2 + _I2 - d2**2 / d1))
  ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
  return torch.stack([dtheta1, dtheta2, ddtheta1, ddtheta2,
                      torch.zeros_like(a)], dim=-1)


def _rk4_step(s_aug, dt):
  k1 = _dsdt(s_aug)
  k2 = _dsdt(s_aug + dt / 2 * k1)
  k3 = _dsdt(s_aug + dt / 2 * k2)
  k4 = _dsdt(s_aug + dt * k3)
  return s_aug + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def _obs(physics):
  t1, t2, dt1, dt2 = physics.unbind(-1)
  return torch.stack([torch.cos(t1), torch.sin(t1), torch.cos(t2),
                      torch.sin(t2), dt1, dt2], dim=-1)


class Acrobot(TorchEnvironment):
  """max_episode_steps=500 mirrors Acrobot-v1."""

  def __init__(self, max_episode_steps: int = 500):
    self.max_episode_steps = max_episode_steps

  def observation_spec(self):
    high = np.array([1.0, 1.0, 1.0, 1.0, _MAX_VEL_1, _MAX_VEL_2],
                    np.float32)
    return array_spec.BoundedArraySpec((6,), np.float32, minimum=-high,
                                       maximum=high, name="observation")

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0, 2, name="action")

  def reset(self, draws, batch_size: int):
    physics = draws.uniform("acrobot_physics", (batch_size, 4), -0.1, 0.1)
    device = physics.device
    state = AcrobotState(
        physics=physics,
        steps=torch.zeros((batch_size,), dtype=torch.int32, device=device),
        terminated=torch.zeros((batch_size,), dtype=torch.bool,
                               device=device))
    return state, ts.restart(_obs(physics), batch_size)

  def step(self, state: AcrobotState, action, draws=None):
    del draws  # no torque noise
    torque = action.to(torch.float32) - 1.0
    ns = _rk4_step(torch.cat([state.physics, torque[:, None]], dim=-1), _DT)
    theta1 = _wrap(ns[:, 0], -math.pi, math.pi)
    theta2 = _wrap(ns[:, 1], -math.pi, math.pi)
    dtheta1 = torch.clamp(ns[:, 2], -_MAX_VEL_1, _MAX_VEL_1)
    dtheta2 = torch.clamp(ns[:, 3], -_MAX_VEL_2, _MAX_VEL_2)
    physics = torch.stack([theta1, theta2, dtheta1, dtheta2], dim=-1)

    steps = state.steps + 1
    terminated = (-torch.cos(theta1) - torch.cos(theta2 + theta1)) > 1.0
    done = terminated | (steps >= self.max_episode_steps)
    reward = torch.where(terminated, 0.0, -1.0).to(torch.float32)
    step_type = torch.where(done, ts.StepType.LAST,
                            ts.StepType.MID).to(torch.int32)
    discount = torch.where(terminated, 0.0, 1.0).to(torch.float32)
    new_state = AcrobotState(physics=physics, steps=steps,
                             terminated=terminated)
    return new_state, ts.TimeStep(step_type=step_type, reward=reward,
                                  discount=discount,
                                  observation=_obs(physics))
