"""TD3.

Port of `Td3Agent`, `Td3AgentState` and `Td3LossExtra` of
``agents_tpu/agents/td3/td3_agent.py`` (:25-203):
  - twin critics trained by one optimizer over both critics' parameters
    (the JAX package's single `critic_optimizer` over ``(c1, c2)``, :91);
  - the critic loss (:107-132): the target actor's next actions plus
    target smoothing noise ``clip(noise * N, +-noise_clip)``, clipped into
    the spec; targets ``scale * r + gamma * d * min(Q'1, Q'2)(s', a')``;
    the squared error against each critic, boundary transitions masked;
  - the actor loss ``-Q1(s, pi(s))`` on critic 1 (:137-142);
  - the delayed actor (:170-183): with ``do_actor = (train_step + 1) %
    actor_update_period == 0`` the actor and its optimizer step on those
    steps only, so the actor's Adam count advances there alone, as the
    JAX step's `where` over both the parameters and the optimizer state
    gives;
  - optional global-norm clipping of each group's gradients;
  - polyak updates of the target actor and both target critics every
    `target_update_period` steps, after the increment; the target actor
    follows the actor whether it moved this step or not (:185-187).

Every loss reads the state from before this step: the actor loss reads
critic 1 before its update, the critic targets read the target networks.
`train` builds both losses, takes each group's gradients with
`torch.autograd.grad` over that group alone, and only then steps the
optimizers. On a step that leaves the actor alone its loss is still
reported, computed without a graph.

The collect policy is ``GaussianPolicy(DeterministicActorPolicy(actor),
exploration_noise_std)``, the eval policy the deterministic actor. The
smoothing noise comes from the agent state's draw source (``Draws(23,
device)`` unless `init` is given one), one draw of ``[S, *action shape]``
at the site "td3_target_noise"; the JAX package draws it from
``fold_in(key(23), train_step)`` (:146-147). The train step is a host int.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from agents_tpu_torch.agents.agent import (Agent, apply_gradients,
                                           check_network_devices,
                                           first_transition)
from agents_tpu_torch.networks.network import seeded_generator
from agents_tpu_torch.policies.actor_policy import DeterministicActorPolicy
from agents_tpu_torch.policies.policy import clip_to_spec
from agents_tpu_torch.policies.wrappers import GaussianPolicy
from agents_tpu_torch.utils import common
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import resolve_device
from agents_tpu_torch.utils.draws import Draws

TARGET_NOISE_SITE = "td3_target_noise"
TRAIN_DRAWS_SEED = 23


@dataclasses.dataclass(frozen=True)
class Td3AgentState:
  actor_network: nn.Module
  critic1_network: nn.Module
  critic2_network: nn.Module
  target_actor_network: nn.Module
  target_critic1_network: nn.Module
  target_critic2_network: nn.Module
  actor_optimizer: torch.optim.Optimizer
  critic_optimizer: torch.optim.Optimizer   # over critic 1's, then 2's
  train_step: int
  draws: Any


@dataclasses.dataclass(frozen=True)
class Td3LossExtra:
  actor_loss: torch.Tensor
  critic_loss: torch.Tensor


class Td3Agent(Agent):
  """TD3: twin critics, a delayed deterministic actor and target policy
  smoothing.

  Args:
    actor_network: a module of ``(observation, step_type, state)`` that
      emits actions (e.g. `DeterministicActorModule`).
    critic_network: critic 1, a module of ``((observation, action),
      step_type, state)`` with a `reset_parameters(generator)` method.
    actor_optimizer_fn, critic_optimizer_fn: build an optimizer from a
      list of parameters, e.g. ``lambda p: torch.optim.Adam(p, lr=3e-4)``.
    generator: draws critic 2, a copy of `critic_network` whose weights are
      drawn anew (the JAX agent inits the one critic architecture twice); a
      fresh generator on the device seeded 1 when None.
    device: where the networks live; "cuda" unless the caller asks for
      "cpu".
  """

  def __init__(self, time_step_spec, action_spec, actor_network: nn.Module,
               critic_network: nn.Module, actor_optimizer_fn: Callable,
               critic_optimizer_fn: Callable,
               exploration_noise_std: float = 0.1,
               target_update_tau: float = 1.0,
               target_update_period: int = 1,
               actor_update_period: int = 1, gamma: float = 1.0,
               reward_scale_factor: float = 1.0,
               target_policy_noise: float = 0.2,
               target_policy_noise_clip: float = 0.5,
               td_errors_loss_fn: Callable = common.element_wise_squared_loss,
               gradient_clipping: Optional[float] = None,
               generator: Optional[torch.Generator] = None, device="cuda"):
    self.device = resolve_device(device)
    check_network_devices(self.device, actor_network=actor_network,
                          critic_network=critic_network)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.actor_network = actor_network
    self.critic_network = critic_network
    self.critic_network_2 = copy.deepcopy(critic_network)
    self.critic_network_2.reset_parameters(
        seeded_generator(self.device, generator, seed=1))
    self.actor_optimizer_fn = actor_optimizer_fn
    self.critic_optimizer_fn = critic_optimizer_fn
    self.target_update_tau = target_update_tau
    self.target_update_period = target_update_period
    self.actor_update_period = actor_update_period
    self.gamma = gamma
    self.reward_scale_factor = reward_scale_factor
    self.target_policy_noise = target_policy_noise
    self.target_policy_noise_clip = target_policy_noise_clip
    self.td_errors_loss_fn = td_errors_loss_fn
    self.gradient_clipping = gradient_clipping
    self.train_sequence_length = 2
    self.policy = DeterministicActorPolicy(time_step_spec, action_spec,
                                           actor_network)
    self.collect_policy = GaussianPolicy(self.policy,
                                         scale=exploration_noise_std)

  def init(self, draws=None) -> Td3AgentState:
    """The state over the agent's networks (trained in place), fresh copies
    for the targets and new optimizers; the smoothing noise comes from
    `draws`, or from ``Draws(23, device)``."""
    a, c1, c2 = self.actor_network, self.critic_network, self.critic_network_2
    target = lambda m: copy.deepcopy(m).requires_grad_(False)  # noqa: E731
    return Td3AgentState(
        actor_network=a, critic1_network=c1, critic2_network=c2,
        target_actor_network=target(a), target_critic1_network=target(c1),
        target_critic2_network=target(c2),
        actor_optimizer=self.actor_optimizer_fn(list(a.parameters())),
        critic_optimizer=self.critic_optimizer_fn(
            list(c1.parameters()) + list(c2.parameters())),
        train_step=0,
        draws=draws if draws is not None else Draws(TRAIN_DRAWS_SEED,
                                                    self.device))

  def policy_params(self, agent_state: Td3AgentState):
    return agent_state.actor_network

  def _actor(self, actor, time_steps):
    a, _ = actor(time_steps.observation, time_steps.step_type, ())
    return a

  def _q(self, critic, time_steps, actions):
    q, _ = critic((time_steps.observation, actions), time_steps.step_type, ())
    return q

  def critic_loss(self, agent_state: Td3AgentState, time_steps, actions,
                  next_time_steps, weights=None):
    """The twin-critic TD loss with target policy smoothing (:107-132)."""
    s = agent_state
    with torch.no_grad():
      target_actions = self._actor(s.target_actor_network, next_time_steps)
      noise = torch.clamp(
          self.target_policy_noise * s.draws.normal(
              TARGET_NOISE_SITE, target_actions.shape,
              dtype=target_actions.dtype),
          -self.target_policy_noise_clip, self.target_policy_noise_clip)
      target_actions = clip_to_spec(target_actions + noise, self.action_spec)
      target_q = torch.minimum(
          self._q(s.target_critic1_network, next_time_steps, target_actions),
          self._q(s.target_critic2_network, next_time_steps, target_actions))
      td_targets = (self.reward_scale_factor * next_time_steps.reward
                    + self.gamma * next_time_steps.discount * target_q)
    per_example = (
        self.td_errors_loss_fn(td_targets,
                               self._q(s.critic1_network, time_steps, actions))
        + self.td_errors_loss_fn(
            td_targets, self._q(s.critic2_network, time_steps, actions)))
    valid_mask = (~time_steps.is_last()).to(torch.float32)
    return common.aggregate_losses(per_example_loss=per_example * valid_mask,
                                   sample_weight=weights)

  def actor_loss(self, agent_state: Td3AgentState, time_steps, weights=None):
    """``-Q1(s, pi(s))`` on the pre-step critic 1 (:137-142)."""
    s = agent_state
    actions = self._actor(s.actor_network, time_steps)
    return common.aggregate_losses(
        per_example_loss=-self._q(s.critic1_network, time_steps, actions),
        sample_weight=weights)

  def train(self, agent_state: Td3AgentState, experience,
            weights=None) -> Tuple[Td3AgentState, LossInfo]:
    """experience: Trajectory [B, 2]."""
    time_steps, actions, next_time_steps = first_transition(experience,
                                                            "Td3Agent")
    s = agent_state
    train_step = s.train_step + 1
    do_actor = train_step % self.actor_update_period == 0
    critic_loss = self.critic_loss(s, time_steps, actions, next_time_steps,
                                   weights)
    with torch.set_grad_enabled(do_actor):
      actor_loss = self.actor_loss(s, time_steps, weights)
    critic_params = (list(s.critic1_network.parameters())
                     + list(s.critic2_network.parameters()))
    groups = [(torch.autograd.grad(critic_loss, critic_params),
               critic_params, s.critic_optimizer)]
    if do_actor:
      actor_params = list(s.actor_network.parameters())
      groups.append((torch.autograd.grad(actor_loss, actor_params),
                     actor_params, s.actor_optimizer))
    # Both gradients are taken before either optimizer steps: the actor
    # loss reads critic 1 before its update.
    apply_gradients(groups, self.gradient_clipping)

    for source, target in (
        (s.actor_network, s.target_actor_network),
        (s.critic1_network, s.target_critic1_network),
        (s.critic2_network, s.target_critic2_network)):
      common.periodic_soft_update(
          train_step, self.target_update_period, source.parameters(),
          target.parameters(), self.target_update_tau)
    extra = Td3LossExtra(actor_loss=actor_loss.detach(),
                         critic_loss=critic_loss.detach())
    return (dataclasses.replace(s, train_step=train_step),
            LossInfo(loss=extra.actor_loss + extra.critic_loss, extra=extra))
