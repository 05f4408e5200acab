"""Pendulum swing-up as a batched on-device environment.

Port of ``agents_tpu/environments/classic/pendulum.py`` (:37-83): Gym's
``Pendulum-v1`` dynamics in float32 over [B] rows. The observation is
``[cos θ, sin θ, θ̇]``, the action a torque ``[B, 1]`` clipped to ±2, the
reward minus the cost ``angle_normalize(θ)² + 0.1 θ̇² + 0.001 u²``. The
step is deterministic; after `max_episode_steps` it emits LAST with
discount 1.0 (truncation, never termination).

Draw sites (reset): "pendulum_theta", uniform [B] in [-π, π), and
"pendulum_theta_dot", uniform [B] in [-1, 1).

The arithmetic keeps the JAX package's order. `_angle_normalize` is
``(x + π) % 2π - π``: `torch.remainder` takes the divisor's sign, as XLA's
``%`` does. `sin`/`cos` may differ from XLA's by an ulp, which the swing's
chaotic dynamics amplify over an episode.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from agents_tpu_torch.environments.torch_environment import TorchEnvironment
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts

_MAX_SPEED = 8.0
_MAX_TORQUE = 2.0
_DT = 0.05
_G = 10.0
_M = 1.0
_L = 1.0


@dataclasses.dataclass(frozen=True)
class PendulumState:
  theta: torch.Tensor      # [B] float32
  theta_dot: torch.Tensor  # [B] float32
  steps: torch.Tensor      # [B] int32


def _angle_normalize(x):
  return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def _obs(theta, theta_dot):
  return torch.stack([torch.cos(theta), torch.sin(theta), theta_dot], dim=-1)


class Pendulum(TorchEnvironment):
  """max_episode_steps=200 mirrors Pendulum-v1."""

  def __init__(self, max_episode_steps: int = 200):
    self.max_episode_steps = max_episode_steps

  def observation_spec(self):
    return array_spec.BoundedArraySpec(
        (3,), np.float32,
        minimum=np.array([-1.0, -1.0, -_MAX_SPEED], np.float32),
        maximum=np.array([1.0, 1.0, _MAX_SPEED], np.float32),
        name="observation")

  def action_spec(self):
    return array_spec.BoundedArraySpec(
        (1,), np.float32, -_MAX_TORQUE, _MAX_TORQUE, name="action")

  def reset(self, draws, batch_size: int):
    theta = draws.uniform("pendulum_theta", (batch_size,), -math.pi, math.pi)
    theta_dot = draws.uniform("pendulum_theta_dot", (batch_size,), -1.0, 1.0)
    state = PendulumState(
        theta=theta, theta_dot=theta_dot,
        steps=torch.zeros((batch_size,), dtype=torch.int32,
                          device=theta.device))
    return state, ts.restart(_obs(theta, theta_dot), batch_size)

  def step(self, state: PendulumState, action, draws=None):
    del draws  # deterministic dynamics
    u = torch.clamp(action[:, 0], -_MAX_TORQUE, _MAX_TORQUE)
    th, thdot = state.theta, state.theta_dot
    cost = (_angle_normalize(th)**2 + 0.1 * thdot**2 + 0.001 * u**2)
    newthdot = thdot + (3 * _G / (2 * _L) * torch.sin(th)
                        + 3.0 / (_M * _L**2) * u) * _DT
    newthdot = torch.clamp(newthdot, -_MAX_SPEED, _MAX_SPEED)
    newth = th + newthdot * _DT
    steps = state.steps + 1
    step_type = torch.where(steps >= self.max_episode_steps,
                            ts.StepType.LAST, ts.StepType.MID).to(torch.int32)
    new_state = PendulumState(theta=newth, theta_dot=newthdot, steps=steps)
    return new_state, ts.TimeStep(
        step_type=step_type, reward=-cost,
        discount=torch.ones_like(cost), observation=_obs(newth, newthdot))
