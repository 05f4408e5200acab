"""DQN / DDQN / D3QN agents, feed-forward Q networks.

Port of `DqnAgent`, `DdqnAgent`, `D3qnAgent` and `_ScheduledQPolicy` of
``agents_tpu/agents/dqn/dqn_agent.py``:
  - epsilon-greedy collect and greedy eval policies; the collect params are
    always {"q", "train_step"} (:105-118);
  - n-step TD targets through `to_n_step_transition`, whose discount already
    holds gamma^(N-1); the loss multiplies by gamma once more (:175);
  - boundary transitions masked, 1/N aggregation;
  - a periodic polyak target update that fires when
    ``train_step % period == 0`` after the increment.

The train step is host-int driven: `DqnAgentState.train_step` is a Python
int (the JAX package keeps a device int32), so the target-update branch
needs no device `where` over every parameter and no sync. The parameters
and optimizer moments are updated in place. Recurrent Q networks
(`_sequence_loss`) are not ported yet.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from agents_tpu_torch.agents.agent import Agent, check_network_devices
from agents_tpu_torch.policies.q_policy import QPolicy
from agents_tpu_torch.policies.wrappers import EpsilonGreedyPolicy, GreedyPolicy
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import common, nest_utils
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import resolve_device


class _ScheduledQPolicy(QPolicy):
  """QPolicy whose params are {"q": network, "train_step": int} so an
  epsilon schedule can read the step at act time."""

  def q_values(self, params, time_step, state=()):
    return super().q_values(params["q"], time_step, state)


@dataclasses.dataclass(frozen=True)
class DqnAgentState:
  q_network: nn.Module
  target_q_network: nn.Module
  optimizer: torch.optim.Optimizer
  train_step: int


@dataclasses.dataclass(frozen=True)
class DqnLossExtra:
  td_loss: torch.Tensor
  td_error: torch.Tensor


class DqnAgent(Agent):
  """Vanilla DQN (max over the target network).

  Args:
    q_network: the online Q network (an nn.Module on `device`); `init`
      trains this module and copies it for the target.
    optimizer_fn: builds the optimizer from the online parameters, e.g.
      ``lambda p: torch.optim.Adam(p, lr=1e-3)`` for ``optax.adam(1e-3)``.
    device: where the networks live; "cuda" unless the caller asks for
      "cpu".
  """

  def __init__(self, time_step_spec, action_spec, q_network: nn.Module,
               optimizer_fn: Callable, epsilon_greedy=0.1,
               n_step_update: int = 1,
               td_errors_loss_fn: Callable = common.element_wise_huber_loss,
               gamma: float = 1.0, reward_scale_factor: float = 1.0,
               target_update_tau: float = 1.0,
               target_update_period: int = 1,
               gradient_clipping: Optional[float] = None,
               train_sequence_length: Optional[int] = None, device="cuda"):
    self.device = resolve_device(device)
    for s in nest_utils.flatten(action_spec, is_leaf=array_spec._is_spec):
      if int(np.asarray(s.minimum)) != 0:
        raise ValueError(
            f"DqnAgent action specs should have minimum of 0, got {s}")
    check_network_devices(self.device, q_network=q_network)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.q_network = q_network
    self.optimizer_fn = optimizer_fn
    self.epsilon_greedy = epsilon_greedy
    self.n_step_update = n_step_update
    self.td_errors_loss_fn = td_errors_loss_fn
    self.gamma = gamma
    self.reward_scale_factor = reward_scale_factor
    self.target_update_tau = target_update_tau
    self.target_update_period = target_update_period
    self.gradient_clipping = gradient_clipping
    self.train_sequence_length = train_sequence_length or n_step_update + 1

    self.policy = GreedyPolicy(QPolicy(time_step_spec, action_spec, q_network))
    eps = epsilon_greedy if callable(epsilon_greedy) \
        else lambda _: epsilon_greedy
    self.collect_policy = EpsilonGreedyPolicy(
        _ScheduledQPolicy(time_step_spec, action_spec, q_network),
        lambda p: eps(p["train_step"]))

  def init(self) -> DqnAgentState:
    target = copy.deepcopy(self.q_network).requires_grad_(False)
    return DqnAgentState(
        q_network=self.q_network, target_q_network=target,
        optimizer=self.optimizer_fn(self.q_network.parameters()),
        train_step=0)

  def policy_params(self, agent_state):
    return agent_state.q_network

  def collect_policy_params(self, agent_state):
    return {"q": agent_state.q_network, "train_step": agent_state.train_step}

  def _next_best_q(self, agent_state, next_time_steps):
    """max_a Q_target(s', a)."""
    q_next, _ = agent_state.target_q_network(
        next_time_steps.observation, next_time_steps.step_type, ())
    return torch.max(q_next, dim=-1).values

  def _loss(self, q_network, agent_state, experience, weights=None):
    """experience: Trajectory [B, T=n_step+1]."""
    transition = tj.to_n_step_transition(experience, gamma=self.gamma)
    time_steps = transition.time_step
    actions = transition.action_step.action
    next_time_steps = transition.next_time_step

    q_all, _ = q_network(time_steps.observation, time_steps.step_type, ())
    q_values = common.index_with_actions(q_all, actions)

    with torch.no_grad():
      next_q = self._next_best_q(agent_state, next_time_steps)
      rewards = self.reward_scale_factor * next_time_steps.reward
      discounts = self.gamma * next_time_steps.discount
      td_targets = rewards + discounts * next_q
    td_error = td_targets - q_values
    td_loss = self.td_errors_loss_fn(td_targets, q_values)

    valid_mask = (~time_steps.is_last()).to(torch.float32)
    td_error = valid_mask * td_error
    td_loss = valid_mask * td_loss

    loss = common.aggregate_losses(per_example_loss=td_loss,
                                   sample_weight=weights)
    return loss, DqnLossExtra(td_loss=td_loss, td_error=td_error)

  def train(self, agent_state: DqnAgentState, experience,
            weights=None) -> Tuple[DqnAgentState, LossInfo]:
    q_network = agent_state.q_network
    optimizer = agent_state.optimizer
    optimizer.zero_grad(set_to_none=True)
    loss, extra = self._loss(q_network, agent_state, experience, weights)
    loss.backward()
    if self.gradient_clipping is not None:
      common.clip_gradient_norms([p.grad for p in q_network.parameters()],
                                 self.gradient_clipping)
    optimizer.step()
    train_step = agent_state.train_step + 1
    common.periodic_soft_update(
        train_step, self.target_update_period, q_network.parameters(),
        agent_state.target_q_network.parameters(), self.target_update_tau)
    new_state = dataclasses.replace(agent_state, train_step=train_step)
    extra = nest_utils.tree_map(torch.Tensor.detach, extra)
    return new_state, LossInfo(loss=loss.detach(), extra=extra)


class DdqnAgent(DqnAgent):
  """Double DQN: online-network argmax, target-network evaluation."""

  def _next_best_q(self, agent_state, next_time_steps):
    q_online, _ = agent_state.q_network(
        next_time_steps.observation, next_time_steps.step_type, ())
    best = torch.argmax(q_online, dim=-1)
    q_target, _ = agent_state.target_q_network(
        next_time_steps.observation, next_time_steps.step_type, ())
    return common.index_with_actions(q_target, best)


# D3QN is Double DQN with a dueling Q network: build the agent with
# ``make_q_network(..., dueling=True)`` (the JAX package's D3qnAgent).
D3qnAgent = DdqnAgent
