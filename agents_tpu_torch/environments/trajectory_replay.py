"""Golden-trajectory tooling.

Port of ``agents_tpu/environments/trajectory_replay.py`` (the reference's
``tf_agents/environments/trajectory_replay.py``): replays recorded actions
through a host env to produce deterministic trajectories for regression
tests, plus a recorder to capture goldens from a host policy
(`JittedPyPolicy` or any object with ``init_state(batch_size)`` and
``action(time_step, state)``).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.trajectories import trajectory as tj


class TrajectoryReplay:
  """Steps `env` with a fixed [T, ...] action sequence and returns the
  emitted trajectory frames (host envs)."""

  def __init__(self, env):
    self.env = env

  def run(self, actions: Sequence) -> List:
    time_step = self.env.reset()
    frames = []
    for action in actions:
      next_time_step = self.env.step(action)
      frames.append(tj.from_transition(
          time_step, ps.PolicyStep(action=np.asarray(action)),
          next_time_step))
      time_step = next_time_step
    return frames


def record_policy_actions(env, policy, num_steps: int):
  """Capture (actions, frames) for golden files."""
  time_step = env.reset()
  state = policy.init_state(env.batch_size)
  actions, frames = [], []
  for _ in range(num_steps):
    step = policy.action(time_step, state)
    next_time_step = env.step(step.action)
    actions.append(np.asarray(step.action))
    frames.append(tj.from_transition(time_step, step, next_time_step))
    time_step = next_time_step
    state = step.state
  return actions, frames
