"""Categorical DQN (C51).

Port of ``agents_tpu/agents/categorical_dqn/categorical_dqn_agent.py``:
  - `project_distribution` (:32-50): the shifted target atoms are
    projected onto the fixed support through a dense ``[B, M, N]``
    triangle kernel and one contraction;
  - `CategoricalDqnAgent` (:59-178): the next action is the argmax of the
    target network's expected Q; the loss is the cross-entropy of the
    online logits of the taken action against the projected target
    distribution, masked on boundary transitions (``~is_last``) and
    averaged over the batch; the target network follows by periodic soft
    updates. With an `observation_and_action_constraint_splitter` the
    policies are masked and the next action is the argmax over the valid
    actions (:128-138).

The train step is a host int and `train` is `DqnAgent.train` (see
``agents/dqn/dqn_agent.py``). The collect policy is epsilon-greedy at a
constant epsilon and its params are the Q network alone (:102).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from agents_tpu_torch.agents.dqn.dqn_agent import DqnAgent
from agents_tpu_torch.policies.q_policy import CategoricalQPolicy
from agents_tpu_torch.policies.wrappers import EpsilonGreedyPolicy, GreedyPolicy
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import common


def project_distribution(supports: torch.Tensor, weights: torch.Tensor,
                         target_support: torch.Tensor) -> torch.Tensor:
  """Project categorical distributions onto `target_support`.

  Args:
    supports: [B, N] atom locations of the source distributions.
    weights: [B, N] their probabilities.
    target_support: [M] fixed, evenly spaced grid.

  Returns [B, M]: the source atoms clipped into the grid's range, each
  spread over its neighbours by the triangle ``1 - |z_n - t_m| / dz``
  clipped to [0, 1].
  """
  v_min, v_max = target_support[0], target_support[-1]
  dz = target_support[1] - target_support[0]
  clipped = torch.clamp(supports, v_min, v_max)
  diff = (clipped[:, None, :] - target_support[None, :, None]).abs()
  tri = torch.clamp(1.0 - diff / dz, 0.0, 1.0)
  return torch.einsum("bmn,bn->bm", tri, weights)


@dataclasses.dataclass(frozen=True)
class C51LossExtra:
  td_loss: torch.Tensor
  cross_entropy: torch.Tensor


def _take_action(dist: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
  """dist[b, actions[b], :] of a [B, A, N] tensor."""
  index = actions.long()[:, None, None].expand(-1, 1, dist.shape[-1])
  return torch.gather(dist, 1, index).squeeze(1)


class CategoricalDqnAgent(DqnAgent):
  """C51 over a `CategoricalQModule` (``make_categorical_q_network``).

  Args are `DqnAgent`'s, with `min_q_value` and `max_q_value` bounding the
  support of ``num_atoms`` atoms (the network's `num_atoms`); the loss is
  the cross-entropy, so there is no `td_errors_loss_fn`.
  """

  def __init__(self, time_step_spec, action_spec,
               categorical_q_network: nn.Module, optimizer_fn: Callable,
               min_q_value: float = -10.0, max_q_value: float = 10.0,
               epsilon_greedy: float = 0.1, n_step_update: int = 1,
               gamma: float = 1.0,
               observation_and_action_constraint_splitter=None,
               reward_scale_factor: float = 1.0,
               target_update_tau: float = 1.0,
               target_update_period: int = 1,
               gradient_clipping: Optional[float] = None, device="cuda"):
    super().__init__(
        time_step_spec, action_spec, categorical_q_network, optimizer_fn,
        epsilon_greedy=epsilon_greedy, n_step_update=n_step_update,
        observation_and_action_constraint_splitter=(
            observation_and_action_constraint_splitter),
        gamma=gamma, reward_scale_factor=reward_scale_factor,
        target_update_tau=target_update_tau,
        target_update_period=target_update_period,
        gradient_clipping=gradient_clipping, device=device)
    self.num_atoms = categorical_q_network.num_atoms
    self._q_policy = CategoricalQPolicy(
        time_step_spec, action_spec, categorical_q_network, min_q_value,
        max_q_value,
        observation_and_action_constraint_splitter=(
            observation_and_action_constraint_splitter))
    self.policy = GreedyPolicy(self._q_policy)
    self.collect_policy = EpsilonGreedyPolicy(self._q_policy, epsilon_greedy)

  @property
  def support(self) -> torch.Tensor:
    """The ``num_atoms`` atoms, ``linspace(min_q_value, max_q_value)``."""
    return self._q_policy.support(self.device)

  def collect_policy_params(self, agent_state):
    return agent_state.q_network

  def _loss(self, q_network, agent_state, experience, weights=None):
    """experience: Trajectory [B, T=n_step+1]."""
    transition = tj.to_n_step_transition(experience, gamma=self.gamma)
    time_steps = transition.time_step
    next_time_steps = transition.next_time_step
    support = self._q_policy.support(self.device)

    with torch.no_grad():
      next_obs, mask = self._q_policy.split(next_time_steps.observation)
      target_logits, _ = agent_state.target_q_network(
          next_obs, next_time_steps.step_type, ())
      target_probs = torch.softmax(target_logits, dim=-1)   # [B, A, N]
      target_q = (target_probs * support).sum(-1)           # [B, A]
      if mask is not None:
        target_q = torch.where(mask, target_q, -1e9)
      best = torch.argmax(target_q, dim=-1)
      next_dist = _take_action(target_probs, best)          # [B, N]
      rewards = self.reward_scale_factor * next_time_steps.reward
      discounts = self.gamma * next_time_steps.discount
      shifted = rewards[:, None] + discounts[:, None] * support[None, :]
      projected = project_distribution(shifted, next_dist, support)

    obs, _ = self._q_policy.split(time_steps.observation)
    logits, _ = q_network(obs, time_steps.step_type, ())
    chosen = _take_action(logits, transition.action_step.action)
    ce = -(projected * torch.log_softmax(chosen, dim=-1)).sum(-1)
    ce = ce * (~time_steps.is_last()).to(torch.float32)
    loss = common.aggregate_losses(per_example_loss=ce, sample_weight=weights)
    return loss, C51LossExtra(td_loss=ce, cross_entropy=ce)
