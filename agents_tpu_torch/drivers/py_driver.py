"""Host driver for host environments.

Port of ``agents_tpu/drivers/py_driver.py``: a Python loop over
``env.step(policy.action(...))`` with boundary-aware counting of
`max_steps` and `max_episodes`. The policy is typically a
`JittedPyPolicy` (acting on the card, the env stepping on the host).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np

from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.trajectories import trajectory as tj


class PyDriver:

  def __init__(self, env, policy, observers: Sequence[Callable] = (),
               transition_observers: Sequence[Callable] = (),
               max_steps: Optional[int] = None,
               max_episodes: Optional[int] = None,
               end_episode_on_boundary: bool = True):
    if not max_steps and not max_episodes:
      raise ValueError("Either max_steps or max_episodes must be set")
    self.env = env
    self.policy = policy
    self.observers = list(observers)
    self.transition_observers = list(transition_observers)
    self.max_steps = max_steps or np.inf
    self.max_episodes = max_episodes or np.inf
    self.end_episode_on_boundary = end_episode_on_boundary

  def run(self, time_step: ts.TimeStep, policy_state=()
          ) -> Tuple[ts.TimeStep, Any]:
    num_steps = 0
    num_episodes = 0
    while num_steps < self.max_steps and num_episodes < self.max_episodes:
      action_step = self.policy.action(time_step, policy_state)
      next_time_step = self.env.step(action_step.action)

      traj = tj.from_transition(time_step, action_step, next_time_step)
      for observer in self.transition_observers:
        observer((time_step, action_step, next_time_step))
      for observer in self.observers:
        observer(traj)

      # Boundary-aware counting: with end_episode_on_boundary (trajectory
      # observers, the default) an episode counts at its boundary frame,
      # otherwise (transition observers) at its terminal frame; boundary
      # frames are no steps.
      is_boundary = np.asarray(traj.is_boundary())
      if self.end_episode_on_boundary:
        num_episodes += np.sum(is_boundary)
      else:
        num_episodes += np.sum(np.asarray(traj.is_last()))
      num_steps += np.sum(~is_boundary)

      time_step = next_time_step
      policy_state = action_step.state
    return time_step, policy_state
