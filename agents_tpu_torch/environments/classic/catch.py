"""Catch (bsuite) as a batched on-device environment.

Port of ``agents_tpu/environments/classic/catch.py`` over [B] rows: a ball
falls one row per step down a `rows` x `columns` board; the agent moves a
paddle on the bottom row left/stay/right (actions 0/1/2) and gets +1 for
catching the ball, -1 for missing it, on the last row (:60-78). The
observation is the float32 board ``[rows, columns, 1]`` with the ball and
the paddle set to 1. Episodes last ``rows - 1`` steps.

Draw site: "catch_ball_col" (reset), randint [B] in [0, columns). The
step is deterministic.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from agents_tpu_torch.environments.torch_environment import TorchEnvironment
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts


@dataclasses.dataclass(frozen=True)
class CatchState:
  ball_row: torch.Tensor    # [B] int32
  ball_col: torch.Tensor    # [B] int32
  paddle_col: torch.Tensor  # [B] int32


class Catch(TorchEnvironment):
  """rows x columns Catch; episode length = rows - 1 steps."""

  def __init__(self, rows: int = 10, columns: int = 5):
    self.rows = rows
    self.columns = columns

  def observation_spec(self):
    return array_spec.BoundedArraySpec(
        (self.rows, self.columns, 1), np.float32, 0.0, 1.0, "board")

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0, 2, "action")

  def _board(self, state: CatchState) -> torch.Tensor:
    device = state.ball_row.device
    r = torch.arange(self.rows, dtype=torch.int32, device=device)[:, None]
    c = torch.arange(self.columns, dtype=torch.int32, device=device)
    ball = ((r == state.ball_row[:, None, None])
            & (c == state.ball_col[:, None, None]))
    paddle = (r == self.rows - 1) & (c == state.paddle_col[:, None, None])
    return (ball | paddle).to(torch.float32)[..., None]

  def reset(self, draws, batch_size: int):
    ball_col = draws.randint("catch_ball_col", (batch_size,), 0,
                             self.columns, dtype=torch.int32)
    state = CatchState(ball_row=torch.zeros_like(ball_col),
                       ball_col=ball_col,
                       paddle_col=torch.full_like(ball_col,
                                                  self.columns // 2))
    return state, ts.restart(self._board(state), batch_size)

  def step(self, state: CatchState, action, draws=None):
    del draws  # deterministic dynamics
    paddle = torch.clamp(state.paddle_col + action.to(torch.int32) - 1, 0,
                         self.columns - 1)
    ball_row = state.ball_row + 1
    new_state = CatchState(ball_row=ball_row, ball_col=state.ball_col,
                           paddle_col=paddle)
    done = ball_row >= self.rows - 1
    caught = paddle == state.ball_col
    reward = torch.where(done, torch.where(caught, 1.0, -1.0), 0.0)
    return new_state, ts.TimeStep(
        step_type=torch.where(done, ts.StepType.LAST,
                              ts.StepType.MID).to(torch.int32),
        reward=reward.to(torch.float32),
        discount=torch.where(done, 0.0, 1.0).to(torch.float32),
        observation=self._board(new_state))
