"""Soft Actor-Critic.

Port of `SacAgent`, `SacAgentState` and `SacLossExtra` of
``agents_tpu/agents/sac/sac_agent.py`` (:33-261):
  - twin critics trained by one optimizer over both critics' parameters
    (the JAX package's single `critic_optimizer` over ``(c1, c2)``, :117,
    :212-214); the actor and `log_alpha` by one optimizer each;
  - the critic loss (:146-166): targets ``scale * r + gamma * d *
    (min(Q'1, Q'2)(s', a') - alpha * log pi(a'|s'))`` with a' drawn from
    the actor, the squared error against each critic, boundary transitions
    masked, the sum weighted by `critic_loss_weight` (0.5);
  - the actor loss ``alpha * log pi - min(Q1, Q2)(s, a)`` with alpha held,
    and the alpha loss ``-log_alpha * (log pi + target_entropy)`` with
    log pi held (:168-182); `target_entropy` defaults to minus the number
    of action dims;
  - optional global-norm clipping of each group's gradients (:209-234);
  - a polyak update of both target critics every `target_update_period`
    steps, after the increment.

Every loss reads the state from before this step, as the JAX step does:
the actor and alpha losses read the critics before their update, and the
critic targets read the actor and log alpha before theirs. The parameters
are updated in place, so `train` builds all three losses first, takes each
group's gradients with `torch.autograd.grad` over that group alone (the
actor loss puts no gradient into the critics), and only then steps the
three optimizers.

The train step's normals come from the agent state's draw source
(``Draws(17, device)`` unless `init` is given one), one draw of
``[S, *leaf shape]`` per action leaf at each of two sites:
"sac_next_action_noise" (the critic targets' next actions) and
"sac_action_noise" (the actor loss's actions). The JAX package draws them
from ``fold_in(key(17), train_step)`` (:189-192). The train step is a host
int.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from agents_tpu_torch.agents.agent import (Agent, apply_gradients,
                                           check_network_devices,
                                           first_transition)
from agents_tpu_torch.networks.network import seeded_generator
from agents_tpu_torch.policies.actor_policy import ActorPolicy
from agents_tpu_torch.policies.wrappers import GreedyPolicy
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import common, nest_utils
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import resolve_device
from agents_tpu_torch.utils.draws import Draws

NEXT_ACTION_SITE = "sac_next_action_noise"
ACTION_SITE = "sac_action_noise"
TRAIN_DRAWS_SEED = 17


@dataclasses.dataclass(frozen=True)
class SacAgentState:
  actor_network: nn.Module
  critic1_network: nn.Module
  critic2_network: nn.Module
  target_critic1_network: nn.Module
  target_critic2_network: nn.Module
  log_alpha: nn.Parameter
  actor_optimizer: torch.optim.Optimizer
  critic_optimizer: torch.optim.Optimizer   # over critic 1's, then 2's
  alpha_optimizer: torch.optim.Optimizer
  train_step: int
  draws: Any


@dataclasses.dataclass(frozen=True)
class SacLossExtra:
  critic_loss: torch.Tensor
  actor_loss: torch.Tensor
  alpha_loss: torch.Tensor


def _is_dist(d) -> bool:
  return hasattr(d, "sample_and_log_prob")


class SacAgent(Agent):
  """SAC with twin critics and a learned temperature.

  Args:
    critic_network: critic 1, a module of ``((observation, action),
      step_type, state)`` with a `reset_parameters(generator)` method.
    actor_network: a module emitting a nest of distributions.
    actor_optimizer_fn, critic_optimizer_fn, alpha_optimizer_fn: build an
      optimizer from a list of parameters, e.g.
      ``lambda p: torch.optim.Adam(p, lr=3e-4)`` for ``optax.adam(3e-4)``.
    generator: draws critic 2, a copy of `critic_network` whose weights
      are drawn anew by its `reset_parameters(generator)` (the JAX agent
      inits the one critic architecture twice); a fresh generator on the
      device seeded 1 when None.
    device: where the networks live; "cuda" unless the caller asks for
      "cpu".
  """

  def __init__(self, time_step_spec, action_spec, critic_network: nn.Module,
               actor_network: nn.Module, actor_optimizer_fn: Callable,
               critic_optimizer_fn: Callable, alpha_optimizer_fn: Callable,
               target_update_tau: float = 0.005,
               target_update_period: int = 1, gamma: float = 0.99,
               reward_scale_factor: float = 1.0,
               target_entropy: Optional[float] = None,
               td_errors_loss_fn: Callable = common.element_wise_squared_loss,
               initial_log_alpha: float = 0.0,
               critic_loss_weight: float = 0.5,
               gradient_clipping: Optional[float] = None,
               generator: Optional[torch.Generator] = None, device="cuda"):
    self.device = resolve_device(device)
    check_network_devices(self.device, critic_network=critic_network,
                          actor_network=actor_network)
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.critic_network = critic_network
    self.critic_network_2 = copy.deepcopy(critic_network)
    self.critic_network_2.reset_parameters(
        seeded_generator(self.device, generator, seed=1))
    self.actor_network = actor_network
    self.actor_optimizer_fn = actor_optimizer_fn
    self.critic_optimizer_fn = critic_optimizer_fn
    self.alpha_optimizer_fn = alpha_optimizer_fn
    self.target_update_tau = target_update_tau
    self.target_update_period = target_update_period
    self.gamma = gamma
    self.reward_scale_factor = reward_scale_factor
    self.td_errors_loss_fn = td_errors_loss_fn
    self.initial_log_alpha = initial_log_alpha
    self.critic_loss_weight = critic_loss_weight
    self.gradient_clipping = gradient_clipping
    self.train_sequence_length = 2
    if target_entropy is None:
      target_entropy = -float(sum(
          int(np.prod(s.shape)) for s in nest_utils.flatten(
              action_spec, is_leaf=array_spec._is_spec)))
    self.target_entropy = target_entropy
    self.collect_policy = ActorPolicy(time_step_spec, action_spec,
                                      actor_network)
    self.policy = GreedyPolicy(self.collect_policy)

  def init(self, draws=None) -> SacAgentState:
    """The state over the agent's networks (trained in place), fresh copies
    for the targets, new optimizers and log alpha; the train step's draws
    come from `draws`, or from ``Draws(17, device)``."""
    c1, c2 = self.critic_network, self.critic_network_2
    log_alpha = nn.Parameter(torch.tensor(
        float(self.initial_log_alpha), dtype=torch.float32,
        device=self.device))
    return SacAgentState(
        actor_network=self.actor_network,
        critic1_network=c1, critic2_network=c2,
        target_critic1_network=copy.deepcopy(c1).requires_grad_(False),
        target_critic2_network=copy.deepcopy(c2).requires_grad_(False),
        log_alpha=log_alpha,
        actor_optimizer=self.actor_optimizer_fn(
            list(self.actor_network.parameters())),
        critic_optimizer=self.critic_optimizer_fn(
            list(c1.parameters()) + list(c2.parameters())),
        alpha_optimizer=self.alpha_optimizer_fn([log_alpha]),
        train_step=0,
        draws=draws if draws is not None else Draws(TRAIN_DRAWS_SEED,
                                                    self.device))

  def policy_params(self, agent_state: SacAgentState):
    return agent_state.actor_network

  def _sample_actions(self, actor, time_steps, draws, site):
    """Actions drawn from `actor` at `site`, one draw per action leaf,
    and their summed log-probabilities."""
    dist, _ = actor(time_steps.observation, time_steps.step_type, ())
    leaves = nest_utils.flatten(dist, is_leaf=_is_dist)
    pairs = [d.sample_and_log_prob(draws, site=site) for d in leaves]
    actions = iter([a for a, _ in pairs])
    log_pi = pairs[0][1]
    for _, lp in pairs[1:]:
      log_pi = log_pi + lp
    return nest_utils.tree_map(lambda _: next(actions), dist,
                               is_leaf=_is_dist), log_pi

  def _q(self, critic, time_steps, actions):
    q, _ = critic((time_steps.observation, actions), time_steps.step_type, ())
    return q

  def critic_loss(self, agent_state: SacAgentState, time_steps, actions,
                  next_time_steps, weights=None):
    """The unweighted twin-critic TD loss (:146-166)."""
    s = agent_state
    with torch.no_grad():
      next_actions, next_log_pi = self._sample_actions(
          s.actor_network, next_time_steps, s.draws, NEXT_ACTION_SITE)
      target_q1 = self._q(s.target_critic1_network, next_time_steps,
                          next_actions)
      target_q2 = self._q(s.target_critic2_network, next_time_steps,
                          next_actions)
      target_value = (torch.minimum(target_q1, target_q2)
                      - torch.exp(s.log_alpha) * next_log_pi)
      td_targets = (self.reward_scale_factor * next_time_steps.reward
                    + self.gamma * next_time_steps.discount * target_value)
    q1 = self._q(s.critic1_network, time_steps, actions)
    q2 = self._q(s.critic2_network, time_steps, actions)
    per_example = (self.td_errors_loss_fn(td_targets, q1)
                   + self.td_errors_loss_fn(td_targets, q2))
    valid_mask = (~time_steps.is_last()).to(torch.float32)
    return common.aggregate_losses(per_example_loss=per_example * valid_mask,
                                   sample_weight=weights)

  def actor_and_alpha_loss(self, agent_state: SacAgentState, time_steps,
                           weights=None):
    """(actor loss, alpha loss) (:168-182)."""
    s = agent_state
    actions, log_pi = self._sample_actions(s.actor_network, time_steps,
                                           s.draws, ACTION_SITE)
    q = torch.minimum(self._q(s.critic1_network, time_steps, actions),
                      self._q(s.critic2_network, time_steps, actions))
    actor_per_example = torch.exp(s.log_alpha).detach() * log_pi - q
    alpha_per_example = -s.log_alpha * (log_pi
                                        + self.target_entropy).detach()
    return (common.aggregate_losses(per_example_loss=actor_per_example,
                                    sample_weight=weights),
            common.aggregate_losses(per_example_loss=alpha_per_example,
                                    sample_weight=weights))

  def train(self, agent_state: SacAgentState, experience,
            weights=None) -> Tuple[SacAgentState, LossInfo]:
    """experience: Trajectory [B, 2]."""
    time_steps, actions, next_time_steps = first_transition(experience,
                                                            "SacAgent")
    s = agent_state
    critic_loss = self.critic_loss_weight * self.critic_loss(
        s, time_steps, actions, next_time_steps, weights)
    actor_loss, alpha_loss = self.actor_and_alpha_loss(s, time_steps,
                                                       weights)
    groups = (
        (critic_loss, list(s.critic1_network.parameters())
         + list(s.critic2_network.parameters()), s.critic_optimizer),
        (actor_loss, list(s.actor_network.parameters()), s.actor_optimizer),
        (alpha_loss, [s.log_alpha], s.alpha_optimizer))
    # Every gradient is taken before any optimizer steps: the losses read
    # the pre-step parameters, which the steps overwrite in place.
    apply_gradients([(torch.autograd.grad(loss, params), params, optimizer)
                     for loss, params, optimizer in groups],
                    self.gradient_clipping)

    train_step = s.train_step + 1
    for source, target in ((s.critic1_network, s.target_critic1_network),
                           (s.critic2_network, s.target_critic2_network)):
      common.periodic_soft_update(
          train_step, self.target_update_period, source.parameters(),
          target.parameters(), self.target_update_tau)
    extra = SacLossExtra(critic_loss=critic_loss.detach(),
                         actor_loss=actor_loss.detach(),
                         alpha_loss=alpha_loss.detach())
    total = extra.critic_loss + extra.actor_loss + extra.alpha_loss
    return (dataclasses.replace(s, train_step=train_step),
            LossInfo(loss=total, extra=extra))
