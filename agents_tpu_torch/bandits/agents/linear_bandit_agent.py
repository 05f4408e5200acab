"""Linear bandit agents: LinUCB and Linear Thompson Sampling.

Port of ``agents_tpu/bandits/agents/linear_bandit_agent.py``:
  - per-arm sufficient statistics A_k = lambda I + sum x xᵀ, b_k = sum r x
    and the pull counts n_k, updated by one batched contraction per train
    call (the [B] -> [K] routing is a one-hot einsum);
  - an optional forgetting factor gamma;
  - data parallelism: over `mesh` (given to the agent, as the JAX
    agent's `axis_name`, or set by a loop built with one), the
    deltas (ΔA, Δb, Δn) are summed over the ranks in one all-reduce of
    their (K·d² + K·d + K) elements, the JAX package's `psum`; the
    gradient-averaging agents of the port average instead.

The train step is a host int. The exploration policy lives in
``bandits/policies/linear_bandit_policy.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from agents_tpu_torch.agents.agent import Agent
from agents_tpu_torch.bandits.policies.linear_bandit_policy import (
    ExplorationStrategy, LinearBanditPolicy)
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LinearBanditState:
  a_mat: torch.Tensor        # [K, d, d]
  b_vec: torch.Tensor        # [K, d]
  num_samples: torch.Tensor  # [K]
  train_step: int


def squeeze_bandit_batch(experience):
  """[B, 1, ...] or [B, T, ...] length-1 episodes -> their first frame
  [B, ...]; flat [B, ...] experience passes through (keyed on the step
  type's rank: rewards may have inner dims)."""
  if experience.step_type.dim() == 2:
    return nest_utils.tree_map(lambda x: x[:, 0], experience)
  return experience


def sum_over_mesh(mesh, *tensors):
  """`tensors` summed over `mesh`'s ranks in one all-reduce of their
  concatenation (as they are without a distributed mesh)."""
  if mesh is None or not mesh.distributed:
    return tensors
  flat = mesh.all_reduce(torch.cat([t.reshape(-1) for t in tensors]),
                         op="sum")
  out, offset = [], 0
  for t in tensors:
    out.append(flat[offset:offset + t.numel()].view_as(t))
    offset += t.numel()
  return tuple(out)


def sufficient_statistics(x, r, actions, num_actions, weights=None):
  """(ΔA [K, d, d], Δb [K, d], Δn [K]) of contexts x [B, d], rewards r
  [B] and actions [B]."""
  onehot = torch.nn.functional.one_hot(actions.long(), num_actions).to(
      x.dtype)                                            # [B, K]
  if weights is not None:
    onehot = onehot * weights[:, None]
  delta_a = torch.einsum("bk,bi,bj->kij", onehot, x, x)
  delta_b = torch.einsum("bk,b,bi->ki", onehot, r, x)
  return delta_a, delta_b, onehot.sum(dim=0)


class LinearBanditAgent(Agent):

  def __init__(self, exploration_strategy: ExplorationStrategy,
               time_step_spec, action_spec, alpha: float = 1.0,
               gamma: float = 1.0, tikhonov_weight: float = 1.0,
               mesh=None, dtype=torch.float32, device="cuda"):
    self.device = resolve_device(device)
    self.mesh = mesh
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.num_actions = action_spec.num_values
    obs_spec = time_step_spec.observation
    self.context_dim = int(np.prod(obs_spec.shape))
    self.alpha = alpha
    self.gamma = gamma
    self.tikhonov_weight = tikhonov_weight
    self.dtype = dtype
    self.train_sequence_length = None  # length-1 episodes

    self.policy = LinearBanditPolicy(
        time_step_spec, action_spec, exploration_strategy, alpha=alpha)
    self.collect_policy = self.policy

  def _eye(self):
    return torch.eye(self.context_dim, dtype=self.dtype,
                     device=self.device) * self.tikhonov_weight

  def init(self) -> LinearBanditState:
    K, d = self.num_actions, self.context_dim
    return LinearBanditState(
        a_mat=self._eye().expand(K, d, d).clone(),
        b_vec=torch.zeros((K, d), dtype=self.dtype, device=self.device),
        num_samples=torch.zeros((K,), dtype=self.dtype, device=self.device),
        train_step=0)

  def policy_params(self, agent_state):
    return agent_state

  def train(self, agent_state: LinearBanditState, experience,
            weights=None) -> Tuple[LinearBanditState, LossInfo]:
    """experience: Trajectory with [B] or [B, T] frames (one bandit round
    in the first frame of each row)."""
    exp = squeeze_bandit_batch(experience)
    obs = exp.observation
    x = obs.reshape(obs.shape[0], -1).to(self.dtype)    # [B, d]
    r = exp.reward.to(self.dtype)                        # [B]
    delta_a, delta_b, delta_n = sum_over_mesh(self.mesh, *sufficient_statistics(
        x, r, exp.action, self.num_actions, weights))

    g = self.gamma
    a_mat = g * agent_state.a_mat + (1 - g) * self._eye()[None] + delta_a
    b_vec = g * agent_state.b_vec + delta_b
    # The reference reports -reward as the loss.
    loss = -torch.mean(r)
    new_state = LinearBanditState(
        a_mat=a_mat, b_vec=b_vec,
        num_samples=agent_state.num_samples + delta_n,
        train_step=agent_state.train_step + 1)
    return new_state, LossInfo(loss=loss, extra=())


class LinUcbAgent(LinearBanditAgent):

  def __init__(self, time_step_spec, action_spec, alpha: float = 1.0,
               gamma: float = 1.0, tikhonov_weight: float = 1.0, **kwargs):
    super().__init__(ExplorationStrategy.optimistic, time_step_spec,
                     action_spec, alpha=alpha, gamma=gamma,
                     tikhonov_weight=tikhonov_weight, **kwargs)


class LinearThompsonSamplingAgent(LinearBanditAgent):

  def __init__(self, time_step_spec, action_spec, alpha: float = 1.0,
               gamma: float = 1.0, tikhonov_weight: float = 1.0, **kwargs):
    super().__init__(ExplorationStrategy.sampling, time_step_spec,
                     action_spec, alpha=alpha, gamma=gamma,
                     tikhonov_weight=tikhonov_weight, **kwargs)
