"""CQL-SAC (offline RL).

Port of `CqlSacAgent`, `CqlSacAgentState` and `CqlSacLossExtra` of
``agents_tpu/agents/cql/cql_sac_agent.py`` (:44-373): SAC plus the
conservative Q-learning regularizer

    E_s[ logsumexp_a' (Q(s, a') temp - log q(a')) / temp - Q(s, a_data) ]

with `num_cql_samples` proposals a' from a uniform distribution over the
action bounds and as many from the pre-step actor, averaged over the two
critics, with no ``log 2n`` normalizer (:111-152). The whole option
surface is kept:

  - `cql_alpha`, or CQL-Lagrange (`use_lagrange_cql_alpha`, `cql_tau`,
    `cql_alpha_learning_rate`, `log_cql_alpha_clipping`): `log_cql_alpha`
    has its own Adam and the loss ``-exp(clip(log_a)) * (cql - tau)`` with
    the CQL term held (:331-351). Its clip is ``min(max(x, lo), hi)`` on
    tensors, whose gradient at a bound is half, as ``jnp.clip``'s is
    (``torch.clamp`` passes the whole gradient there);
  - `include_critic_entropy_term` (the SAC entropy bonus in the TD target)
    and `reward_noise_variance` (rewards plus ``N * variance``, the
    variance as the JAX step has it, :172-175);
  - `num_bc_steps`: while ``train_step < num_bc_steps`` (a host int) the
    actor clones the data actions (``alpha * log pi - log pi(a_data)``),
    the data actions clipped ``1e-3 * (max - min)`` into the interior of
    the bounds first (:217-256); the entropy log-probs are still drawn;
  - `softmax_temperature`, and `bc_debug_mode` (the critics train on the
    CQL term alone, :278-294).

The critic step minimises ``critic_loss_weight * TD + cql_alpha * CQL``.
Every loss reads the pre-step state, as in the SAC port: all gradients
are taken with `torch.autograd.grad` before any optimizer steps. The
proposals of both critics go through one forward per critic: ``2n``
proposals and the data action, ``(2n + 1) * S`` rows, whose last S rows
are the data Q of both the CQL gap and the TD term.

The train step's draws come from the agent state's source (``Draws(7,
device)`` unless `init` is given one; the JAX package draws from
``fold_in(key(7), train_step)``, :262-264), at the sites
"cql_next_action_noise" ``[S, *leaf]``, "cql_reward_noise" ``[S]`` (only
with reward noise), "cql_uniform_actions" ``[n, S, *leaf]`` uniform in
[0, 1) and scaled to [min, max), "cql_policy_noise" ``[n, S, *leaf]`` and
"cql_action_noise" ``[S, *leaf]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from agents_tpu_torch.agents.agent import apply_gradients, first_transition
from agents_tpu_torch.agents.sac.sac_agent import SacAgent, _is_dist
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import common, nest_utils
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.draws import Draws

NEXT_ACTION_SITE = "cql_next_action_noise"
REWARD_NOISE_SITE = "cql_reward_noise"
UNIFORM_ACTIONS_SITE = "cql_uniform_actions"
POLICY_NOISE_SITE = "cql_policy_noise"
ACTION_SITE = "cql_action_noise"


@dataclasses.dataclass(frozen=True)
class CqlSacAgentState:
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
  log_cql_alpha: nn.Parameter
  cql_alpha_optimizer: torch.optim.Optimizer


@dataclasses.dataclass(frozen=True)
class CqlSacLossExtra:
  critic_loss: torch.Tensor
  actor_loss: torch.Tensor
  alpha_loss: torch.Tensor
  cql_loss: torch.Tensor
  cql_alpha: torch.Tensor
  cql_alpha_loss: torch.Tensor


def _jax_clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
  """``jnp.clip``: ``min(max(x, lo), hi)``, half the gradient at a bound."""
  return torch.minimum(torch.maximum(x, torch.full_like(x, lo)),
                       torch.full_like(x, hi))


def _tile(x: torch.Tensor, k: int) -> torch.Tensor:
  """``[S, ...]`` -> ``[k * S, ...]``, the S rows repeated k times."""
  return x.unsqueeze(0).expand((k,) + tuple(x.shape)).reshape(
      (k * x.shape[0],) + tuple(x.shape[1:]))


class CqlSacAgent(SacAgent):
  """SAC with the CQL(H) regularizer; the arguments after `*` are the
  JAX agent's (:62-73), the rest `SacAgent`'s."""

  def __init__(self, *args, cql_alpha: float = 5.0,
               num_cql_samples: int = 10,
               include_critic_entropy_term: bool = False,
               use_lagrange_cql_alpha: bool = False,
               cql_alpha_learning_rate: float = 1e-4,
               cql_tau: float = 10.0, reward_noise_variance: float = 0.0,
               num_bc_steps: int = 0, softmax_temperature: float = 1.0,
               log_cql_alpha_clipping: Optional[Tuple[float, float]] = None,
               bc_debug_mode: bool = False, random_seed: int = 7, **kwargs):
    super().__init__(*args, **kwargs)
    if reward_noise_variance < 0:
      raise ValueError(
          f"reward_noise_variance must be >= 0, got {reward_noise_variance}")
    specs = nest_utils.flatten(self.action_spec, is_leaf=array_spec._is_spec)
    if len(specs) != 1:
      raise ValueError(
          f"CqlSacAgent takes one bounded action spec, got {len(specs)}")
    self.cql_alpha = cql_alpha
    self.num_cql_samples = num_cql_samples
    self.include_critic_entropy_term = include_critic_entropy_term
    self.use_lagrange_cql_alpha = use_lagrange_cql_alpha
    self.cql_alpha_learning_rate = cql_alpha_learning_rate
    self.cql_tau = cql_tau
    self.reward_noise_variance = reward_noise_variance
    self.num_bc_steps = num_bc_steps
    self.softmax_temperature = softmax_temperature
    self.log_cql_alpha_clipping = log_cql_alpha_clipping
    self.bc_debug_mode = bc_debug_mode
    self.random_seed = random_seed
    spec = specs[0]
    lo = np.broadcast_to(np.asarray(spec.minimum, np.float32), spec.shape)
    hi = np.broadcast_to(np.asarray(spec.maximum, np.float32), spec.shape)
    self._action_low = torch.as_tensor(lo.copy(), device=self.device)
    self._action_range = torch.as_tensor((hi - lo).copy(), device=self.device)
    # Uniform density (1 / range)^dims: log q = -sum(log range), float32.
    self._log_uniform = float(np.sum(-np.log(hi - lo) * np.ones(
        spec.shape, np.float32), dtype=np.float32))
    margin = 1e-3 * (hi - lo)
    self._interior = (torch.as_tensor((lo + margin).copy(),
                                      device=self.device),
                      torch.as_tensor((hi - margin).copy(),
                                      device=self.device))

  def init(self, draws=None) -> CqlSacAgentState:
    """SAC's state plus `log_cql_alpha` (log of `cql_alpha`) and its Adam;
    the train step's draws come from `draws`, or from ``Draws(7,
    device)``."""
    base = super().init(draws if draws is not None else Draws(
        self.random_seed, self.device))
    log_cql_alpha = nn.Parameter(torch.tensor(
        float(np.log(self.cql_alpha)), dtype=torch.float32,
        device=self.device))
    return CqlSacAgentState(
        **{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
        log_cql_alpha=log_cql_alpha,
        cql_alpha_optimizer=torch.optim.Adam(
            [log_cql_alpha], lr=self.cql_alpha_learning_rate))

  def _get_cql_alpha(self, agent_state: CqlSacAgentState):
    """The CQL weight: `cql_alpha`, or ``exp(clip(log_cql_alpha))``."""
    if not self.use_lagrange_cql_alpha:
      return self.cql_alpha
    log_a = agent_state.log_cql_alpha
    if self.log_cql_alpha_clipping is not None:
      log_a = _jax_clip(log_a, *self.log_cql_alpha_clipping)
    return torch.exp(log_a)

  def _one_dist(self, actor, time_steps):
    dist, _ = actor(time_steps.observation, time_steps.step_type, ())
    return nest_utils.flatten(dist, is_leaf=_is_dist)[0]

  def _q_on(self, critic, time_steps, actions, k):
    """Q of critic on `actions` ``[k * S, ...]`` at the S states tiled k
    times."""
    observation = nest_utils.tree_map(lambda x: _tile(x, k),
                                      time_steps.observation)
    q, _ = critic((observation, actions), _tile(time_steps.step_type, k), ())
    return q

  def _cql_terms(self, agent_state: CqlSacAgentState, time_steps, actions):
    """(CQL gap averaged over the two critics, data Q1, data Q2) (:111-152).

    Each critic sees ``[policy proposals; uniform proposals; data
    actions]`` in one forward of ``(2n + 1) * S`` rows."""
    s = agent_state
    n, temp = self.num_cql_samples, self.softmax_temperature
    batch = time_steps.step_type.shape[0]
    leaf_shape = tuple(self._action_range.shape)
    u = s.draws.uniform(UNIFORM_ACTIONS_SITE, (n, batch) + leaf_shape)
    uniform_actions = u * self._action_range + self._action_low
    with torch.no_grad():
      pi_actions, pi_log_probs = self._one_dist(
          s.actor_network, time_steps).sample_and_log_prob(
              s.draws, (n,), site=POLICY_NOISE_SITE)     # [n, S, ...], [n, S]
    proposals = torch.cat([pi_actions, uniform_actions,
                           actions.unsqueeze(0)]).reshape(
                               ((2 * n + 1) * batch,) + leaf_shape)
    gaps, data_q = [], []
    for critic in (s.critic1_network, s.critic2_network):
      q = self._q_on(critic, time_steps, proposals, 2 * n + 1).reshape(
          2 * n + 1, batch)
      combined = torch.cat([q[:n] * temp - pi_log_probs,
                            q[n:2 * n] * temp - self._log_uniform])
      lse = torch.logsumexp(combined, dim=0) / temp
      gaps.append(torch.mean(lse - q[2 * n]))
      data_q.append(q[2 * n])
    return (gaps[0] + gaps[1]) / 2.0, data_q[0], data_q[1]

  def _td_loss(self, agent_state: CqlSacAgentState, q1, q2, time_steps,
               next_time_steps, weights=None):
    """SAC's TD loss on the data Q values, with the optional entropy term
    and reward noise (:154-186)."""
    s = agent_state
    with torch.no_grad():
      next_actions, next_log_pi = self._sample_actions(
          s.actor_network, next_time_steps, s.draws, NEXT_ACTION_SITE)
      target_value = torch.minimum(
          self._q(s.target_critic1_network, next_time_steps, next_actions),
          self._q(s.target_critic2_network, next_time_steps, next_actions))
      if self.include_critic_entropy_term:
        target_value = target_value - torch.exp(s.log_alpha) * next_log_pi
      reward = next_time_steps.reward
      if self.reward_noise_variance > 0:
        reward = reward + s.draws.normal(
            REWARD_NOISE_SITE, reward.shape) * self.reward_noise_variance
      td_targets = (self.reward_scale_factor * reward
                    + self.gamma * next_time_steps.discount * target_value)
    per_example = (self.td_errors_loss_fn(td_targets, q1)
                   + self.td_errors_loss_fn(td_targets, q2))
    valid_mask = (~time_steps.is_last()).to(torch.float32)
    return common.aggregate_losses(per_example_loss=per_example * valid_mask,
                                   sample_weight=weights)

  def critic_loss(self, agent_state: CqlSacAgentState, time_steps, actions,
                  next_time_steps, weights=None):
    """The TD part of the critic loss, without the CQL term or the
    `critic_loss_weight` (:154-186): SAC's, with the entropy term in the
    target only under `include_critic_entropy_term`, and reward noise
    when `reward_noise_variance` > 0."""
    s = agent_state
    return self._td_loss(s, self._q(s.critic1_network, time_steps, actions),
                         self._q(s.critic2_network, time_steps, actions),
                         time_steps, next_time_steps, weights)

  def _data_log_prob(self, actor, time_steps, actions):
    """The actor's log-prob of the data actions, clipped ``1e-3 * (max -
    min)`` into the interior of the bounds (:217-256)."""
    lo, hi = self._interior
    return self._one_dist(actor, time_steps).log_prob(
        torch.minimum(torch.maximum(actions, lo), hi))

  def actor_and_alpha_loss(self, agent_state: CqlSacAgentState, time_steps,
                           weights=None, data_actions=None):
    """(actor loss, alpha loss) (:188-215): SAC's, or behavioural cloning
    of `data_actions` while ``train_step < num_bc_steps``."""
    s = agent_state
    actions, log_pi = self._sample_actions(s.actor_network, time_steps,
                                           s.draws, ACTION_SITE)
    alpha = torch.exp(s.log_alpha).detach()
    if (self.num_bc_steps > 0 and data_actions is not None
        and s.train_step < self.num_bc_steps):
      actor_per_example = alpha * log_pi - self._data_log_prob(
          s.actor_network, time_steps, data_actions)
    else:
      q = torch.minimum(self._q(s.critic1_network, time_steps, actions),
                        self._q(s.critic2_network, time_steps, actions))
      actor_per_example = alpha * log_pi - q
    alpha_per_example = -s.log_alpha * (log_pi + self.target_entropy).detach()
    return (common.aggregate_losses(per_example_loss=actor_per_example,
                                    sample_weight=weights),
            common.aggregate_losses(per_example_loss=alpha_per_example,
                                    sample_weight=weights))

  def train(self, agent_state: CqlSacAgentState, experience,
            weights=None) -> Tuple[CqlSacAgentState, LossInfo]:
    """experience: Trajectory [B, 2]."""
    time_steps, actions, next_time_steps = first_transition(experience,
                                                            "CqlSacAgent")
    s = agent_state
    cql_alpha = self._get_cql_alpha(s)
    held_alpha = (cql_alpha.detach() if isinstance(cql_alpha, torch.Tensor)
                  else cql_alpha)
    cql_loss, q1, q2 = self._cql_terms(s, time_steps, actions)
    if self.bc_debug_mode:
      critic_loss = cql_loss * held_alpha
    else:
      critic_loss = (self.critic_loss_weight * self._td_loss(
          s, q1, q2, time_steps, next_time_steps, weights)
                     + cql_loss * held_alpha)
    actor_loss, alpha_loss = self.actor_and_alpha_loss(
        s, time_steps, weights, data_actions=actions)

    critic_params = (list(s.critic1_network.parameters())
                     + list(s.critic2_network.parameters()))
    actor_params = list(s.actor_network.parameters())
    groups = [
        (torch.autograd.grad(critic_loss, critic_params), critic_params,
         s.critic_optimizer),
        (torch.autograd.grad(actor_loss, actor_params), actor_params,
         s.actor_optimizer),
        (torch.autograd.grad(alpha_loss, [s.log_alpha]), [s.log_alpha],
         s.alpha_optimizer)]
    # CQL-Lagrange: the alpha player ascends alpha * (gap - tau).
    cql_alpha_loss = torch.zeros((), device=self.device)
    lagrange = []
    if self.use_lagrange_cql_alpha:
      cql_alpha_loss = -cql_alpha * (cql_loss.detach() - self.cql_tau)
      lagrange = [(torch.autograd.grad(cql_alpha_loss, [s.log_cql_alpha]),
                   [s.log_cql_alpha], s.cql_alpha_optimizer)]
    # Every gradient is taken before any optimizer steps; the Lagrange
    # gradient is not clipped (nor is it in the JAX step).
    apply_gradients(groups, self.gradient_clipping, self.mesh)
    apply_gradients(lagrange, None, self.mesh)

    train_step = s.train_step + 1
    for source, target in ((s.critic1_network, s.target_critic1_network),
                           (s.critic2_network, s.target_critic2_network)):
      common.periodic_soft_update(
          train_step, self.target_update_period, source.parameters(),
          target.parameters(), self.target_update_tau)
    extra = CqlSacLossExtra(
        critic_loss=critic_loss.detach(), actor_loss=actor_loss.detach(),
        alpha_loss=alpha_loss.detach(), cql_loss=cql_loss.detach(),
        cql_alpha=(held_alpha if isinstance(held_alpha, torch.Tensor)
                   else torch.full((), held_alpha, device=self.device)),
        cql_alpha_loss=cql_alpha_loss.detach())
    return (dataclasses.replace(s, train_step=train_step),
            LossInfo(loss=extra.critic_loss + extra.actor_loss
                     + extra.alpha_loss, extra=extra))
