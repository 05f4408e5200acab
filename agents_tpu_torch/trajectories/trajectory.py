"""Trajectory / Transition and the conversions the main path uses.

Port of ``agents_tpu/trajectories/trajectory.py``: `Trajectory`,
`Transition`, `from_transition` (:152), `to_transition` (:166),
`to_n_step_transition` (:194), `trajectory_spec` (:248) and
`check_adjacent_transition_sequence` (:262).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import nest_utils


@dataclasses.dataclass(frozen=True)
class Trajectory:
  """One (batched/time-stacked) frame of experience.

  ``reward``/``discount``/``next_step_type`` at index ``t`` describe the
  result of taking ``action[t]`` from ``observation[t]``.
  """
  step_type: Any
  observation: Any
  action: Any
  policy_info: Any
  next_step_type: Any
  reward: Any
  discount: Any

  def is_first(self):
    return self.step_type == ts.StepType.FIRST

  def is_last(self):
    return self.next_step_type == ts.StepType.LAST

  def is_boundary(self):
    return self.step_type == ts.StepType.LAST

  def replace(self, **kwargs) -> "Trajectory":
    return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class Transition:
  """(time_step, action_step, next_time_step)."""
  time_step: ts.TimeStep
  action_step: ps.PolicyStep
  next_time_step: ts.TimeStep


def from_transition(time_step: ts.TimeStep, action_step: ps.PolicyStep,
                    next_time_step: ts.TimeStep) -> Trajectory:
  """Trajectory frame from a transition."""
  return Trajectory(
      step_type=time_step.step_type,
      observation=time_step.observation,
      action=action_step.action,
      policy_info=action_step.info,
      next_step_type=next_time_step.step_type,
      reward=next_time_step.reward,
      discount=next_time_step.discount)


def to_transition(trajectory: Trajectory,
                  next_trajectory: Optional[Trajectory] = None
                  ) -> Transition:
  """Transitions from adjacent trajectory frames.

  With no `next_trajectory`, `trajectory` is ``[B, T, ...]`` and is sliced
  along time into T-1 transitions. `time_step.reward` and `.discount` are
  zero-filled (undefined), as in the JAX package.
  """
  if next_trajectory is None:
    next_trajectory = nest_utils.tree_map(lambda t: t[:, 1:], trajectory)
    trajectory = nest_utils.tree_map(lambda t: t[:, :-1], trajectory)
  policy_steps = ps.PolicyStep(
      action=trajectory.action, state=(), info=trajectory.policy_info)
  time_steps = ts.TimeStep(
      step_type=trajectory.step_type,
      reward=nest_utils.tree_map(torch.zeros_like, trajectory.reward),
      discount=torch.zeros_like(trajectory.discount),
      observation=trajectory.observation)
  next_time_steps = ts.TimeStep(
      step_type=trajectory.next_step_type,
      reward=trajectory.reward,
      discount=trajectory.discount,
      observation=next_trajectory.observation)
  return Transition(time_steps, policy_steps, next_time_steps)


def to_n_step_transition(trajectory: Trajectory, gamma) -> Transition:
  """N-step transition from a ``[B, T=N+1]`` trajectory.

  next_time_step.reward   = sum_{n<N} gamma^n * prod_{m<n} d_m * r_n
  next_time_step.discount = gamma^(N-1) * prod_{n<N} d_n

  The final discount carries gamma^(N-1); the DQN loss multiplies by gamma
  once more. The first frame's reward and discount are undefined and
  NaN-filled, as in the JAX package.
  """
  discount_bt = trajectory.discount
  if discount_bt.dim() != 2:
    raise ValueError(
        "to_n_step_transition requires [B, T] discount; got "
        f"{tuple(discount_bt.shape)}")
  time_dim = discount_bt.shape[1]
  if time_dim < 2:
    raise ValueError(f"Trajectory frame count must be >= 2, saw {time_dim}")
  n = time_dim - 1

  first_frame = nest_utils.tree_map(lambda t: t[:, 0], trajectory)
  final_frame = nest_utils.tree_map(lambda t: t[:, -1], trajectory)

  reward = trajectory.reward[:, :-1]        # [B, N]
  discount = trajectory.discount[:, :-1]    # [B, N]
  # cum[n] = prod_{m<n} d_m (exclusive product)
  cum = torch.cat([torch.ones_like(discount[:, :1]),
                   torch.cumprod(discount, dim=1)[:, :-1]], dim=1)
  powers = float(gamma) ** torch.arange(n, dtype=reward.dtype,
                                        device=reward.device)
  discounted_reward = torch.sum(reward * powers[None, :] * cum, dim=1)
  final_discount = float(gamma) ** (n - 1) * torch.prod(discount, dim=1)

  policy_steps = ps.PolicyStep(
      action=first_frame.action, state=(), info=first_frame.policy_info)
  time_steps = ts.TimeStep(
      step_type=first_frame.step_type,
      reward=nest_utils.tree_map(lambda r: torch.full_like(r, float("nan")),
                                 first_frame.reward),
      discount=torch.full_like(first_frame.discount, float("nan")),
      observation=first_frame.observation)
  next_time_steps = ts.TimeStep(
      step_type=final_frame.step_type,
      reward=discounted_reward,
      discount=final_discount,
      observation=final_frame.observation)
  return Transition(time_steps, policy_steps, next_time_steps)


def trajectory_spec(time_step_spec: ts.TimeStep, action_spec,
                    policy_info_spec=()) -> Trajectory:
  """Spec nest matching Trajectory frames (the `collect_data_spec`)."""
  return Trajectory(
      step_type=time_step_spec.step_type,
      observation=time_step_spec.observation,
      action=action_spec,
      policy_info=policy_info_spec,
      next_step_type=time_step_spec.step_type,
      reward=time_step_spec.reward,
      discount=time_step_spec.discount)


def check_adjacent_transition_sequence(experience: Trajectory,
                                       agent_name: str) -> None:
  """Raise unless `experience` is ``[B, 2]``: `to_transition` of a longer
  window gives T-1 transitions, and an agent that keeps the first would
  drop the rest silently. Reads the shape only, so it never syncs."""
  shape = tuple(experience.step_type.shape)
  if len(shape) != 2 or shape[1] != 2:
    raise ValueError(
        f"{agent_name} trains on adjacent-frame transitions "
        f"(train_sequence_length=2); got experience with step_type shape "
        f"{shape}. Sample replay with num_steps=2.")
