"""Synthetic Atari-shaped pixel environment (84x84x4 uint8, on the device).

Port of ``agents_tpu/environments/classic/synthetic_pixels.py`` over [B]
rows. It stands in for ALE at the mnih15 operating shape: the conv
Q-network over frame-stacked 84x84 uint8 observations, uint8 replay
storage and the fused loop, with an observation that costs one broadcast
integer pattern per step.

Task: a hidden target action in [0, num_actions) is encoded into the pixel
pattern ``(r*3 + c*5 + f*7 + target*41 + t*13) % 251``; playing it yields
reward 1. A new target is drawn every step. Episodes end with LAST and
discount 0 at ``t >= horizon``.

Draw sites: "pixels_target" (reset) and "pixels_step_target" (step),
randint [B] in [0, num_actions).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from agents_tpu_torch.environments.torch_environment import TorchEnvironment
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts


@dataclasses.dataclass(frozen=True)
class SyntheticPixelsState:
  target: torch.Tensor  # [B] int32: the rewarded action
  t: torch.Tensor       # [B] int32: step within the episode


class SyntheticPixels(TorchEnvironment):
  """`size` x `size` x `frames` uint8 observations."""

  def __init__(self, size: int = 84, frames: int = 4, num_actions: int = 6,
               horizon: int = 500):
    self.size = size
    self.frames = frames
    self.num_actions = num_actions
    self.horizon = horizon

  def observation_spec(self):
    return array_spec.BoundedArraySpec(
        (self.size, self.size, self.frames), np.uint8, 0, 255, "pixels")

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0,
                                       self.num_actions - 1, "action")

  def _obs(self, state: SyntheticPixelsState) -> torch.Tensor:
    device = state.t.device
    r = torch.arange(self.size, dtype=torch.int32, device=device)
    f = torch.arange(self.frames, dtype=torch.int32, device=device)
    base = r[:, None, None] * 3 + r[None, :, None] * 5 + f * 7  # [S, S, F]
    offset = state.target * 41 + state.t * 13                   # [B]
    return ((base + offset[:, None, None, None]) % 251).to(torch.uint8)

  def reset(self, draws, batch_size: int):
    target = draws.randint("pixels_target", (batch_size,), 0,
                           self.num_actions, dtype=torch.int32)
    state = SyntheticPixelsState(target=target, t=torch.zeros_like(target))
    return state, ts.restart(self._obs(state), batch_size)

  def step(self, state: SyntheticPixelsState, action, draws):
    reward = (action.to(torch.int32) == state.target).to(torch.float32)
    target = draws.randint("pixels_step_target", tuple(state.t.shape), 0,
                           self.num_actions, dtype=torch.int32)
    t = state.t + 1
    new_state = SyntheticPixelsState(target=target, t=t)
    done = t >= self.horizon
    return new_state, ts.TimeStep(
        step_type=torch.where(done, ts.StepType.LAST,
                              ts.StepType.MID).to(torch.int32),
        reward=reward,
        discount=torch.where(done, 0.0, 1.0).to(torch.float32),
        observation=self._obs(new_state))
