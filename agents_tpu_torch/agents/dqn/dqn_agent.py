"""DQN / DDQN / D3QN agents, feed-forward Q networks.

Port of `DqnAgent`, `DdqnAgent`, `D3qnAgent` and `_ScheduledQPolicy` of
``agents_tpu/agents/dqn/dqn_agent.py``:
  - epsilon-greedy collect and greedy eval policies; the collect params are
    always {"q", "train_step"} (:105-118); with `boltzmann_temperature` the
    collect policy is a `BoltzmannPolicy` over the Q policy and its params
    the Q network (:100-103);
  - an `observation_and_action_constraint_splitter` maps observations to
    ``(network observation, mask)``: the policies become masked and the
    next state's max (DDQN: the online argmax) runs over the valid actions
    alone (:141-152);
  - action specs whose minimum is not 0 raise `ValueError`;
  - n-step TD targets through `to_n_step_transition`, whose discount already
    holds gamma^(N-1); the loss multiplies by gamma once more (:175);
  - boundary transitions masked, 1/N aggregation;
  - a periodic polyak target update that fires when
    ``train_step % period == 0`` after the increment.

A recurrent Q network (one with a `state_spec`, `lstm_networks`) trains on
``[B, T]`` sequences of `train_sequence_length` (`_sequence_loss`,
:196-230): the online and the target network each unroll once from a zero
carry with FIRST-step resets, TD pairs are the frames ``(t, t + 1)``,
frames whose step is LAST are masked, and the loss sums over time, then
averages over the batch. The next state's value is the masked max of the
target unroll (`_seq_next_best_q`, :188-194); DDQN's is the target unroll
at the argmax of the online one (:271-280).

The train step is host-int driven: `DqnAgentState.train_step` is a Python
int (the JAX package keeps a device int32), so the target-update branch
needs no device `where` over every parameter and no sync. The parameters
and optimizer moments are updated in place.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from agents_tpu_torch.agents.agent import (APPLY_SPAN, GRAD_SPAN, LOSS_SPAN,
                                           Agent, apply_gradients,
                                           check_network_devices)
from agents_tpu_torch.policies.q_policy import QPolicy
from agents_tpu_torch.policies.wrappers import (BoltzmannPolicy,
                                                EpsilonGreedyPolicy,
                                                GreedyPolicy)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import common, nest_utils, profiling
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
               boltzmann_temperature: Optional[float] = None,
               observation_and_action_constraint_splitter=None,
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

    splitter = observation_and_action_constraint_splitter
    self._q_policy = QPolicy(
        time_step_spec, action_spec, q_network,
        observation_and_action_constraint_splitter=splitter)
    self.policy = GreedyPolicy(self._q_policy)
    self._collect_carries_step = boltzmann_temperature is None
    if boltzmann_temperature is not None:
      self.collect_policy = BoltzmannPolicy(self._q_policy,
                                            boltzmann_temperature)
    else:
      eps = epsilon_greedy if callable(epsilon_greedy) \
          else lambda _: epsilon_greedy
      self.collect_policy = EpsilonGreedyPolicy(
          _ScheduledQPolicy(
              time_step_spec, action_spec, q_network,
              observation_and_action_constraint_splitter=splitter),
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
    if self._collect_carries_step:
      return {"q": agent_state.q_network,
              "train_step": agent_state.train_step}
    return agent_state.q_network

  def _next_best_q(self, agent_state, next_time_steps):
    """max_a Q_target(s', a) over the valid actions (:141-152)."""
    obs, mask = self._q_policy.split(next_time_steps.observation)
    q_next, _ = agent_state.target_q_network(obs, next_time_steps.step_type,
                                             ())
    if mask is not None:
      q_next = torch.where(mask, q_next, -1e9)
    return torch.max(q_next, dim=-1).values

  def _loss(self, q_network, agent_state, experience, weights=None):
    """experience: Trajectory [B, T=n_step+1], or [B, T] sequences for a
    recurrent Q network."""
    if self.q_network.state_spec:
      return self._sequence_loss(q_network, agent_state, experience, weights)
    transition = tj.to_n_step_transition(experience, gamma=self.gamma)
    time_steps = transition.time_step
    actions = transition.action_step.action
    next_time_steps = transition.next_time_step

    obs, _ = self._q_policy.split(time_steps.observation)
    q_all, _ = q_network(obs, time_steps.step_type, ())
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

  def _seq_next_best_q(self, q_all_online, target_all, action_mask):
    """The next states' values from the ``[B, T, A]`` unrolls: the masked
    max of the target network's."""
    del q_all_online
    if action_mask is not None:
      target_all = torch.where(action_mask, target_all, -1e9)
    return torch.max(target_all, dim=-1).values

  def _sequence_loss(self, q_network, agent_state, experience, weights=None):
    """TD over the adjacent frames of whole sequences (recurrent Q)."""
    obs, action_mask = self._q_policy.split(experience.observation)
    step_type = experience.step_type
    q_all, _ = q_network(obs, step_type, None)                # [B, T, A]
    q_taken = common.index_with_actions(q_all, experience.action)
    with torch.no_grad():
      target_all, _ = agent_state.target_q_network(obs, step_type, None)
      next_q = self._seq_next_best_q(q_all.detach(), target_all, action_mask)
      rewards = self.reward_scale_factor * experience.reward[:, :-1]
      discounts = self.gamma * experience.discount[:, :-1]
      td_targets = rewards + discounts * next_q[:, 1:]
    td_error = td_targets - q_taken[:, :-1]
    td_loss = self.td_errors_loss_fn(td_targets, q_taken[:, :-1])
    valid = (step_type[:, :-1] != ts.StepType.LAST).to(torch.float32)
    td_loss = td_loss * valid
    td_error = td_error * valid
    loss = common.aggregate_losses(per_example_loss=td_loss.sum(dim=1),
                                   sample_weight=weights)
    return loss, DqnLossExtra(td_loss=td_loss, td_error=td_error)

  def train(self, agent_state: DqnAgentState, experience,
            weights=None) -> Tuple[DqnAgentState, LossInfo]:
    q_network = agent_state.q_network
    with LOSS_SPAN:
      loss, extra = self._loss(q_network, agent_state, experience, weights)
    with GRAD_SPAN:
      params = list(q_network.parameters())
      grads = torch.autograd.grad(loss, params, allow_unused=True)
    train_step = agent_state.train_step + 1
    with APPLY_SPAN:
      apply_gradients([(grads, params, agent_state.optimizer)],
                      self.gradient_clipping, self.mesh)
      common.periodic_soft_update(
          train_step, self.target_update_period, q_network.parameters(),
          agent_state.target_q_network.parameters(), self.target_update_tau)
    profiling.count("agent.train_steps")
    new_state = dataclasses.replace(agent_state, train_step=train_step)
    extra = nest_utils.tree_map(torch.Tensor.detach, extra)
    return new_state, LossInfo(loss=loss.detach(), extra=extra)


class DdqnAgent(DqnAgent):
  """Double DQN: online-network argmax, target-network evaluation."""

  def _next_best_q(self, agent_state, next_time_steps):
    obs, mask = self._q_policy.split(next_time_steps.observation)
    q_online, _ = agent_state.q_network(obs, next_time_steps.step_type, ())
    if mask is not None:
      q_online = torch.where(mask, q_online, -1e9)
    best = torch.argmax(q_online, dim=-1)
    q_target, _ = agent_state.target_q_network(obs, next_time_steps.step_type,
                                               ())
    return common.index_with_actions(q_target, best)

  def _seq_next_best_q(self, q_all_online, target_all, action_mask):
    """The target unroll at the online unroll's (masked) argmax; the
    online values come in detached."""
    if action_mask is not None:
      q_all_online = torch.where(action_mask, q_all_online, -1e9)
    best = torch.argmax(q_all_online, dim=-1)
    return common.index_with_actions(target_all, best)


# D3QN is Double DQN with a dueling Q network: build the agent with
# ``make_q_network(..., dueling=True)`` (the JAX package's D3qnAgent).
D3qnAgent = DdqnAgent
