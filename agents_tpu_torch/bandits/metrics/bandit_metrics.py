"""Bandit metrics: regret, suboptimal arms, constraint violations and
distance from greedy.

Port of ``agents_tpu/bandits/metrics/bandit_metrics.py``: (sum, count)
accumulators over the frames whose next step is LAST (the frames that
carry a round's reward), updated during collection with no host read. Over a
data-parallel mesh (``update(state, traj, mesh)``) each rank adds the sums
over every rank's rows, so every rank holds what the JAX package's
replicated accumulator holds.
"""
from __future__ import annotations

from typing import Callable

import torch

from agents_tpu_torch.metrics.torch_metrics import Metric


def _accumulate(state, values, valid, mesh):
  """state + (sum of values, count of valid rows), summed over the mesh's
  ranks in one all-reduce."""
  total, count = state
  sums = torch.stack([torch.sum(values * valid), torch.sum(valid)])
  if mesh is not None:
    sums = mesh.all_reduce(sums)
  return total + sums[0], count + sums[1]


class _MeanMetric(Metric):
  """A mean over the rounds seen: init, result."""

  def init(self, batch_size: int, device=None):
    return (torch.zeros((), device=device), torch.zeros((), device=device))

  def result(self, state):
    total, count = state
    return total / torch.clamp(count, min=1.0)


class RegretMetric(_MeanMetric):
  """Mean per-round regret = optimal expected reward - received reward."""
  name = "RegretMetric"

  def __init__(self, baseline_reward_fn: Callable):
    self.baseline_reward_fn = baseline_reward_fn

  def update(self, state, traj, mesh=None):
    optimal = self.baseline_reward_fn(traj.observation)
    valid = traj.is_last().to(torch.float32)
    return _accumulate(state, optimal - traj.reward, valid, mesh)


class SuboptimalArmsMetric(_MeanMetric):
  """Fraction of rounds where a suboptimal arm was pulled."""
  name = "SuboptimalArmsMetric"

  def __init__(self, optimal_action_fn: Callable):
    self.optimal_action_fn = optimal_action_fn

  def update(self, state, traj, mesh=None):
    best = self.optimal_action_fn(traj.observation)
    valid = traj.is_last().to(torch.float32)
    subopt = (traj.action != best).to(torch.float32)
    return _accumulate(state, subopt, valid, mesh)


class ConstraintViolationsMetric(_MeanMetric):
  """Mean violations of an action-feasibility constraint fn."""
  name = "ConstraintViolationsMetric"

  def __init__(self, constraint_fn: Callable):
    """constraint_fn(observation, action) -> violation in [0, 1]."""
    self.constraint_fn = constraint_fn

  def update(self, state, traj, mesh=None):
    valid = traj.is_last().to(torch.float32)
    v = self.constraint_fn(traj.observation, traj.action)
    return _accumulate(state, v, valid, mesh)


class DistanceFromGreedyMetric(_MeanMetric):
  """Mean gap between the highest *estimated* reward and the estimated
  reward of the action taken (belief-relative, unlike regret)."""
  name = "DistanceFromGreedyMetric"

  def __init__(self, estimated_reward_fn: Callable):
    """estimated_reward_fn(observation) -> [..., num_actions] estimates."""
    self.estimated_reward_fn = estimated_reward_fn

  def update(self, state, traj, mesh=None):
    est = self.estimated_reward_fn(traj.observation)
    best = torch.max(est, dim=-1).values
    taken = torch.gather(est, -1, traj.action.long()[..., None])[..., 0]
    valid = traj.is_last().to(torch.float32)
    return _accumulate(state, best - taken, valid, mesh)
