"""A synthetic grasp on the device: QT-Opt's observation and action shapes.

It stands in for QT-Opt's bin of objects (Kalashnikov et al. 2018) at the
paper's shapes: a 472 x 472 x 3 uint8 camera image and the gripper's
state (closed, height) in, QT-Opt's 8-float action out, episodes of at
most 20 steps. Each of B rows holds one hidden object on the table and a
gripper above it; both are drawn into the image every step.

Geometry: the table is the square [-1, 1]^2 and heights run from 0 (the
table) to 1. At reset the object's position (x, y) is drawn uniform in
[-0.75, 0.75]^2 ("grasp_object", [B, 2]); the gripper starts open at (0,
0, 1).

Action: ``[t (3), r (2), g_close, g_open, e]``: t moves the gripper by
``step_size * t`` (clipped to the table and to heights [0, 1]); r, the
sine and cosine of a vertical rotation, is taken and not modelled; the
last three are a one-hot command read by their argmax: close the
gripper, open it, or end the episode. Closing within `grasp_radius` of
the object (the distance from the gripper to the object on the table, in
three dimensions) is a success: reward 1 and the episode ends. Ending the
episode earns 0, and so does every other step; the `horizon`-th step ends
the episode too. Every end is LAST with discount 0.

Image: pixel (i, j) has the centre ``u = (i + 0.5) * 2 / size - 1`` (rows,
y) and ``v = (j + 0.5) * 2 / size - 1`` (columns, x). The background is
the texture ``(3 i + 5 j + 7 c) % 64 + 32`` in channel c; the object is a
disc of radius 0.1, ``(v - x)^2 + (u - y)^2 < 0.01`` in float32, painted
(200, 40, 40); the gripper a square of half-width 0.06 about its (x, y),
``|v - gx| < 0.06`` and ``|u - gy| < 0.06``, painted (40, 55 + 200 *
(1 - height) truncated to an integer, 200 if closed else 40), over the
object.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from agents_tpu_torch.environments.torch_environment import TorchEnvironment
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts

ACTION_SIZE = 8
OBJECT_RADIUS = 0.1
GRIPPER_HALF_WIDTH = 0.06
OBJECT_RANGE = 0.75


@dataclasses.dataclass(frozen=True)
class SyntheticGraspState:
  object_xy: torch.Tensor  # [B, 2] float32
  gripper: torch.Tensor    # [B, 3] float32: x, y, height
  closed: torch.Tensor     # [B] float32: 1 closed, 0 open
  t: torch.Tensor          # [B] int32: step within the episode


class SyntheticGrasp(TorchEnvironment):
  """`size` x `size` x 3 uint8 images and the gripper's state."""

  def __init__(self, size: int = 472, horizon: int = 20,
               step_size: float = 0.1, grasp_radius: float = 0.25):
    self.size = size
    self.horizon = horizon
    self.step_size = step_size
    self.grasp_radius = grasp_radius
    self._constants = {}

  def observation_spec(self):
    return {"image": array_spec.BoundedArraySpec(
                (self.size, self.size, 3), np.uint8, 0, 255, "image"),
            "state": array_spec.BoundedArraySpec((2,), np.float32, 0.0, 1.0,
                                                 "state")}

  def action_spec(self):
    return array_spec.BoundedArraySpec(
        (ACTION_SIZE,), np.float32, [-1.0] * 5 + [0.0] * 3, 1.0, "action")

  def _constant(self, device) -> dict:
    """The pixel centres [S] in (-1, 1), the background texture [S, S, 3]
    and the colours and bounds, made on `device` once, so a step copies
    nothing to the card."""
    if device not in self._constants:
      i = torch.arange(self.size, dtype=torch.int32, device=device)
      c = torch.arange(3, dtype=torch.int32, device=device)
      self._constants[device] = {
          "centres": (i.to(torch.float32) + 0.5) * (2.0 / self.size) - 1.0,
          "texture": ((i[:, None, None] * 3 + i[None, :, None] * 5 + c * 7)
                      % 64 + 32).to(torch.uint8),
          "object": torch.tensor([200, 40, 40], dtype=torch.uint8,
                                 device=device),
          "start": torch.tensor([0.0, 0.0, 1.0], device=device),
          "low": torch.tensor([-1.0, -1.0, 0.0], device=device),
          "high": torch.ones(3, device=device)}
    return self._constants[device]

  def _obs(self, state: SyntheticGraspState):
    const = self._constant(state.t.device)
    centres, texture = const["centres"], const["texture"]
    u, v = centres[None, :, None], centres[None, None, :]      # rows, cols
    ox, oy = state.object_xy[:, 0, None, None], state.object_xy[:, 1, None,
                                                                None]
    disc = (v - ox) * (v - ox) + (u - oy) * (u - oy) < (
        OBJECT_RADIUS * OBJECT_RADIUS)
    gx, gy = state.gripper[:, 0, None, None], state.gripper[:, 1, None, None]
    square = ((v - gx).abs() < GRIPPER_HALF_WIDTH) & (
        (u - gy).abs() < GRIPPER_HALF_WIDTH)
    green = (55.0 + 200.0 * (1.0 - state.gripper[:, 2])).to(torch.uint8)
    blue = torch.where(state.closed > 0, 200, 40).to(torch.uint8)
    gripper = torch.stack([torch.full_like(green, 40), green, blue], -1)
    image = torch.where(disc[..., None], const["object"], texture)
    image = torch.where(square[..., None], gripper[:, None, None, :], image)
    gripper_state = torch.stack([state.closed, state.gripper[:, 2]], -1)
    return {"image": image, "state": gripper_state}

  def reset(self, draws, batch_size: int):
    object_xy = draws.uniform("grasp_object", (batch_size, 2), -OBJECT_RANGE,
                              OBJECT_RANGE)
    device = object_xy.device
    gripper = self._constant(device)["start"].expand(batch_size, 3)
    state = SyntheticGraspState(
        object_xy=object_xy, gripper=gripper,
        closed=torch.zeros(batch_size, device=device),
        t=torch.zeros(batch_size, dtype=torch.int32, device=device))
    return state, ts.restart(self._obs(state), batch_size)

  def step(self, state: SyntheticGraspState, action, draws):
    action = action.to(torch.float32)
    const = self._constant(action.device)
    gripper = torch.minimum(torch.maximum(
        state.gripper + self.step_size * action[:, :3], const["low"]),
        const["high"])
    command = torch.argmax(action[:, 5:], dim=-1)     # close, open, end
    close, open_, end = command == 0, command == 1, command == 2
    dx = gripper[:, 0] - state.object_xy[:, 0]
    dy = gripper[:, 1] - state.object_xy[:, 1]
    dz = gripper[:, 2]
    near = dx * dx + dy * dy + dz * dz < self.grasp_radius ** 2
    success = close & near
    closed = torch.where(close, 1.0, torch.where(open_, 0.0, state.closed))
    t = state.t + 1
    done = success | end | (t >= self.horizon)
    new_state = SyntheticGraspState(object_xy=state.object_xy,
                                    gripper=gripper, closed=closed, t=t)
    return new_state, ts.TimeStep(
        step_type=torch.where(done, ts.StepType.LAST,
                              ts.StepType.MID).to(torch.int32),
        reward=success.to(torch.float32),
        discount=torch.where(done, 0.0, 1.0).to(torch.float32),
        observation=self._obs(new_state))
