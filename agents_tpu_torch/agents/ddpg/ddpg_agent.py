"""DDPG.

Port of `DdpgAgent`, `DdpgAgentState` and `DdpgLossExtra` of
``agents_tpu/agents/ddpg/ddpg_agent.py`` (:24-177): a deterministic actor
and one critic, target copies of both, one optimizer each.
  - the critic loss (:97-111): targets ``scale * r + gamma * d *
    Q'(s', pi'(s'))``, the squared error, boundary transitions masked;
  - the actor loss (:113-133): ``-Q(s, pi(s))``, or with `dqda_clipping`
    the surrogate ``-sum(clip(dQ/da) * pi(s))`` over the action's dims, with
    dQ/da taken on a detached copy of the actions and held fixed; either
    way the actor's gradient reaches the actor alone;
  - optional global-norm clipping of each group's gradients, then both
    optimizers step; polyak updates of both targets every
    `target_update_period` steps, after the increment.

As in the TD3 port, both losses read the pre-step networks and both
gradients are taken before either optimizer steps. The collect policy is
``OUNoisePolicy(DeterministicActorPolicy(actor), ou_stddev, ou_damping)``,
whose OU state rides in the driver's policy state.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from agents_tpu_torch.agents.agent import (Agent, apply_gradients,
                                           check_network_devices,
                                           first_transition)
from agents_tpu_torch.policies.actor_policy import DeterministicActorPolicy
from agents_tpu_torch.policies.wrappers import OUNoisePolicy
from agents_tpu_torch.utils import common
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DdpgAgentState:
  actor_network: nn.Module
  critic_network: nn.Module
  target_actor_network: nn.Module
  target_critic_network: nn.Module
  actor_optimizer: torch.optim.Optimizer
  critic_optimizer: torch.optim.Optimizer
  train_step: int


@dataclasses.dataclass(frozen=True)
class DdpgLossExtra:
  actor_loss: torch.Tensor
  critic_loss: torch.Tensor


class DdpgAgent(Agent):
  """DDPG with Ornstein-Uhlenbeck exploration.

  Args:
    actor_network: a module of ``(observation, step_type, state)`` that
      emits actions (e.g. `DeterministicActorModule`).
    critic_network: a module of ``((observation, action), step_type,
      state)``.
    actor_optimizer_fn, critic_optimizer_fn: build an optimizer from a
      list of parameters.
    device: where the networks live; "cuda" unless the caller asks for
      "cpu".
  """

  def __init__(self, time_step_spec, action_spec, actor_network: nn.Module,
               critic_network: nn.Module, actor_optimizer_fn: Callable,
               critic_optimizer_fn: Callable, ou_stddev: float = 1.0,
               ou_damping: float = 1.0, target_update_tau: float = 1.0,
               target_update_period: int = 1, gamma: float = 1.0,
               reward_scale_factor: float = 1.0,
               td_errors_loss_fn: Callable = common.element_wise_squared_loss,
               dqda_clipping: Optional[float] = None,
               gradient_clipping: Optional[float] = None, device="cuda"):
    self.device = resolve_device(device)
    check_network_devices(self.device, actor_network=actor_network,
                          critic_network=critic_network)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.actor_network = actor_network
    self.critic_network = critic_network
    self.actor_optimizer_fn = actor_optimizer_fn
    self.critic_optimizer_fn = critic_optimizer_fn
    self.target_update_tau = target_update_tau
    self.target_update_period = target_update_period
    self.gamma = gamma
    self.reward_scale_factor = reward_scale_factor
    self.td_errors_loss_fn = td_errors_loss_fn
    self.dqda_clipping = dqda_clipping
    self.gradient_clipping = gradient_clipping
    self.train_sequence_length = 2
    self.policy = DeterministicActorPolicy(time_step_spec, action_spec,
                                           actor_network)
    self.collect_policy = OUNoisePolicy(self.policy, ou_stddev=ou_stddev,
                                        ou_damping=ou_damping)

  def init(self) -> DdpgAgentState:
    """The state over the agent's networks (trained in place), fresh copies
    for the targets and new optimizers."""
    a, c = self.actor_network, self.critic_network
    target = lambda m: copy.deepcopy(m).requires_grad_(False)  # noqa: E731
    return DdpgAgentState(
        actor_network=a, critic_network=c, target_actor_network=target(a),
        target_critic_network=target(c),
        actor_optimizer=self.actor_optimizer_fn(list(a.parameters())),
        critic_optimizer=self.critic_optimizer_fn(list(c.parameters())),
        train_step=0)

  def policy_params(self, agent_state: DdpgAgentState):
    return agent_state.actor_network

  def _actor(self, actor, time_steps):
    a, _ = actor(time_steps.observation, time_steps.step_type, ())
    return a

  def _q(self, critic, time_steps, actions):
    q, _ = critic((time_steps.observation, actions), time_steps.step_type, ())
    return q

  def critic_loss(self, agent_state: DdpgAgentState, time_steps, actions,
                  next_time_steps, weights=None):
    """The TD loss (:97-111)."""
    s = agent_state
    with torch.no_grad():
      target_actions = self._actor(s.target_actor_network, next_time_steps)
      target_q = self._q(s.target_critic_network, next_time_steps,
                         target_actions)
      td_targets = (self.reward_scale_factor * next_time_steps.reward
                    + self.gamma * next_time_steps.discount * target_q)
    q = self._q(s.critic_network, time_steps, actions)
    valid_mask = (~time_steps.is_last()).to(torch.float32)
    return common.aggregate_losses(
        per_example_loss=self.td_errors_loss_fn(td_targets, q) * valid_mask,
        sample_weight=weights)

  def actor_loss(self, agent_state: DdpgAgentState, time_steps,
                 weights=None):
    """``-Q(s, pi(s))``, or the clipped-dQ/da surrogate (:113-133)."""
    s = agent_state
    actions = self._actor(s.actor_network, time_steps)
    if self.dqda_clipping is not None:
      held = actions.detach().requires_grad_(True)
      q = self._q(s.critic_network, time_steps, held)
      (dqda,) = torch.autograd.grad(q.sum(), held)
      dqda = torch.clamp(dqda, -self.dqda_clipping, self.dqda_clipping)
      per_example = torch.sum(-dqda * actions,
                              dim=tuple(range(1, actions.dim())))
    else:
      per_example = -self._q(s.critic_network, time_steps, actions)
    return common.aggregate_losses(per_example_loss=per_example,
                                   sample_weight=weights)

  def train(self, agent_state: DdpgAgentState, experience,
            weights=None) -> Tuple[DdpgAgentState, LossInfo]:
    """experience: Trajectory [B, 2]."""
    time_steps, actions, next_time_steps = first_transition(experience,
                                                            "DdpgAgent")
    s = agent_state
    critic_loss = self.critic_loss(s, time_steps, actions, next_time_steps,
                                   weights)
    actor_loss = self.actor_loss(s, time_steps, weights)
    critic_params = list(s.critic_network.parameters())
    actor_params = list(s.actor_network.parameters())
    # Both gradients before either step: the actor loss reads the critic
    # before its update.
    apply_gradients(
        [(torch.autograd.grad(critic_loss, critic_params), critic_params,
          s.critic_optimizer),
         (torch.autograd.grad(actor_loss, actor_params), actor_params,
          s.actor_optimizer)], self.gradient_clipping)

    train_step = s.train_step + 1
    for source, target in ((s.actor_network, s.target_actor_network),
                           (s.critic_network, s.target_critic_network)):
      common.periodic_soft_update(
          train_step, self.target_update_period, source.parameters(),
          target.parameters(), self.target_update_tau)
    extra = DdpgLossExtra(actor_loss=actor_loss.detach(),
                          critic_loss=critic_loss.detach())
    return (dataclasses.replace(s, train_step=train_step),
            LossInfo(loss=extra.actor_loss + extra.critic_loss, extra=extra))
