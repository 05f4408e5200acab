"""PPO (clip variant, optional KL cutoff and adaptive KL penalty).

Port of `PPOAgent`, `PPOAgentState` and `PPOLossExtra` of
``agents_tpu/agents/ppo/ppo_agent.py`` (:41-451). One `train` call, on a
``[B, T]`` trajectory from `PPOPolicy`:

  1. updates the observation and reward normalizers from the rollout;
  2. computes GAE advantages and TD-lambda returns from the collect-time
     value predictions, restarting the recursion at every episode-final
     transition (``next_step_type == LAST``);
  3. flattens the ``[:, :-1]`` window to ``B * (T - 1)`` frames, masks the
     boundary frames, and normalizes the advantages;
  4. runs `num_epochs` epochs, each a fresh permutation of the frames
     (draw site "ppo_permutation") cut into `num_minibatches` minibatches,
     one optimizer step per minibatch over the actor's, then the value
     network's parameters (optax's single optimizer over the tuple
     ``(actor, value)``), with optional global-norm gradient clipping;
  5. with an adaptive KL penalty, moves beta by 1.5x from the mean KL of
     the full batch under the final policy.

The losses are the clipped surrogate (or the plain one without clipping),
the value error (optionally clipped around the collect-time values), the
entropy bonus, the KL cutoff penalty and ``beta * mean KL``. Each loss
reads the parameters before its minibatch's step and the normalizer state
after step 1, as the JAX step does.

The optimizer is built by ``optimizer_fn(parameters)``; `lr_schedule`,
when given, multiplies its learning rate by ``lr_schedule(count)`` at the
optimizer's step `count` (a `LambdaLR` stepped after each optimizer step:
``optax.adam(optax.linear_schedule(lr, 0, n))`` is ``optimizer_fn=lambda p:
Adam(p, lr)`` with ``lr_schedule=lambda c: 1 - min(c, n) / n``). The train
step is a host int and beta a device scalar, so `train` makes no host
sync. Its permutations come from the `draws` passed in (the on-policy
loop's), else from the agent state's ``Draws(31, device)``; the JAX agent
draws them from `key` or ``fold_in(key(31), train_step)``.

Not ported here: recurrent networks (`_recurrent`, :123-124, :306-307) and
sharded minibatches (`num_minibatch_shards > 1`); both raise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
from torch import nn

from agents_tpu_torch.agents.agent import Agent, check_network_devices
from agents_tpu_torch.agents.ppo.ppo_policy import PPOPolicy
from agents_tpu_torch.policies.wrappers import GreedyPolicy
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import common, nest_utils, value_ops
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.device import resolve_device
from agents_tpu_torch.utils.draws import Draws
from agents_tpu_torch.utils.tensor_normalizer import StreamingTensorNormalizer

PERMUTATION_SITE = "ppo_permutation"
TRAIN_DRAWS_SEED = 31


@dataclasses.dataclass(frozen=True)
class PPOAgentState:
  actor_network: nn.Module
  value_network: nn.Module
  optimizer: torch.optim.Optimizer   # over the actor's, then the value's
  lr_scheduler: Any                  # LambdaLR over `optimizer`, or None
  obs_norm_state: Any
  reward_norm_state: Any
  kl_beta: torch.Tensor
  train_step: int
  draws: Any


@dataclasses.dataclass(frozen=True)
class PPOLossExtra:
  policy_gradient_loss: torch.Tensor
  value_estimation_loss: torch.Tensor
  entropy_reg_loss: torch.Tensor
  kl_penalty_loss: torch.Tensor
  clip_fraction: torch.Tensor


def _kl(old_dist, dist) -> torch.Tensor:
  """Summed KL(old || new) over a nest of distributions."""
  kls = nest_utils.flatten(nest_utils.tree_map(
      lambda o, n: o.kl_divergence(n), old_dist, dist,
      is_leaf=lambda d: hasattr(d, "kl_divergence")))
  total = kls[0]
  for kl in kls[1:]:
    total = total + kl
  return total


class PPOAgent(Agent):
  """PPO over an actor network and a value network.

  Args:
    optimizer_fn: builds the optimizer from the list of the actor's, then
      the value network's parameters, e.g. ``lambda p:
      torch.optim.Adam(p, lr=3e-4)`` for ``optax.adam(3e-4)``.
    lr_schedule: optional learning-rate multiplier of the optimizer's step
      count (see the module docstring).
    device: where the networks live; "cuda" unless the caller asks for
      "cpu".
  """

  def __init__(self, time_step_spec, action_spec, optimizer_fn: Callable,
               actor_network: nn.Module, value_network: nn.Module,
               importance_ratio_clipping: float = 0.2,
               discount_factor: float = 0.99,
               lambda_value: float = 0.95,
               num_epochs: int = 10,
               num_minibatches: int = 1,
               num_minibatch_shards: int = 1,
               entropy_regularization: float = 0.0,
               value_pred_loss_coef: float = 0.5,
               use_gae: bool = True,
               use_td_lambda_return: bool = True,
               normalize_observations: bool = True,
               normalize_rewards: bool = True,
               normalize_advantages: bool = True,
               reward_norm_clipping: float = 10.0,
               value_clipping: Optional[float] = None,
               initial_adaptive_kl_beta: float = 0.0,
               adaptive_kl_target: float = 0.01,
               adaptive_kl_tolerance: float = 0.3,
               kl_cutoff_factor: float = 0.0,
               kl_cutoff_coef: float = 1000.0,
               gradient_clipping: Optional[float] = None,
               lr_schedule: Optional[Callable[[int], float]] = None,
               device="cuda"):
    self.device = resolve_device(device)
    check_network_devices(self.device, actor_network=actor_network,
                          value_network=value_network)
    if actor_network.state_spec or value_network.state_spec:
      raise NotImplementedError(
          "recurrent PPO (lstm_networks) is not ported yet (ROADMAP A10)")
    if num_minibatch_shards > 1:
      raise NotImplementedError(
          "num_minibatch_shards > 1 (sharded minibatches) is not ported "
          "yet (ROADMAP A14)")
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.optimizer_fn = optimizer_fn
    self.lr_schedule = lr_schedule
    self.actor_network = actor_network
    self.value_network = value_network
    self.importance_ratio_clipping = importance_ratio_clipping
    self.gamma = discount_factor
    self.lambda_value = lambda_value
    self.num_epochs = num_epochs
    self.num_minibatches = num_minibatches
    self.num_minibatch_shards = num_minibatch_shards
    self.entropy_regularization = entropy_regularization
    self.value_pred_loss_coef = value_pred_loss_coef
    self.use_gae = use_gae
    self.use_td_lambda_return = use_td_lambda_return
    self.normalize_advantages = normalize_advantages
    self.reward_norm_clipping = reward_norm_clipping
    self.value_clipping = value_clipping
    self.initial_adaptive_kl_beta = initial_adaptive_kl_beta
    self.adaptive_kl_target = adaptive_kl_target
    self.adaptive_kl_tolerance = adaptive_kl_tolerance
    self.kl_cutoff_factor = kl_cutoff_factor
    self.kl_cutoff_coef = kl_cutoff_coef
    self.gradient_clipping = gradient_clipping
    self.train_sequence_length = None  # full [B, T] rollouts

    self.obs_normalizer = (
        StreamingTensorNormalizer(time_step_spec.observation)
        if normalize_observations else None)
    self.reward_normalizer = (
        StreamingTensorNormalizer(time_step_spec.reward)
        if normalize_rewards else None)

    self.collect_policy = PPOPolicy(
        time_step_spec, action_spec, actor_network, value_network,
        observation_normalizer=self.obs_normalizer)
    self.policy = GreedyPolicy(self.collect_policy)

  # -- lifecycle -----------------------------------------------------------
  def init(self, draws=None) -> PPOAgentState:
    """The state over the agent's networks (trained in place), a new
    optimizer (and schedule), fresh normalizer states and beta; permutations
    come from `draws`, or from ``Draws(31, device)``."""
    optimizer = self.optimizer_fn(list(self.actor_network.parameters())
                                  + list(self.value_network.parameters()))
    scheduler = (torch.optim.lr_scheduler.LambdaLR(optimizer,
                                                   self.lr_schedule)
                 if self.lr_schedule is not None else None)
    return PPOAgentState(
        actor_network=self.actor_network, value_network=self.value_network,
        optimizer=optimizer, lr_scheduler=scheduler,
        obs_norm_state=(self.obs_normalizer.init(self.device)
                        if self.obs_normalizer else ()),
        reward_norm_state=(self.reward_normalizer.init(self.device)
                           if self.reward_normalizer else ()),
        kl_beta=torch.tensor(float(self.initial_adaptive_kl_beta),
                             dtype=torch.float32, device=self.device),
        train_step=0,
        draws=draws if draws is not None else Draws(TRAIN_DRAWS_SEED,
                                                    self.device))

  def policy_params(self, agent_state: PPOAgentState):
    return {"actor": agent_state.actor_network,
            "value": agent_state.value_network,
            "normalizer": agent_state.obs_norm_state}

  # -- advantages ------------------------------------------------------------
  @torch.no_grad()
  def compute_return_and_advantage(self, agent_state: PPOAgentState,
                                   experience):
    """Returns and advantages ``[B, T-1]`` over the window ``[:, :-1]``,
    frame T-1's value prediction the bootstrap."""
    rewards = experience.reward[:, :-1]
    if self.reward_normalizer is not None:
      # Scaled, not centered.
      rewards = self.reward_normalizer.normalize(
          agent_state.reward_norm_state, rewards,
          clip_value=self.reward_norm_clipping, center_mean=False)
    discounts = self.gamma * experience.discount[:, :-1]
    # The recursion restarts at every episode-final transition, also at a
    # time limit whose discount stays 1.
    episode_mask = (experience.next_step_type[:, :-1]
                    != ts.StepType.LAST).to(discounts.dtype)
    discounts = discounts * episode_mask
    value_preds = experience.policy_info["value_prediction"]  # [B, T]

    values_tm = value_preds[:, :-1].transpose(0, 1)
    final_value = value_preds[:, -1]
    rewards_tm = rewards.transpose(0, 1)
    discounts_tm = discounts.transpose(0, 1)

    def _returns():
      return value_ops.discounted_return(
          rewards_tm, discounts_tm, final_value=final_value).transpose(0, 1)

    if self.use_gae:
      advantages = value_ops.generalized_advantage_estimation(
          values_tm, final_value, discounts_tm, rewards_tm,
          td_lambda=self.lambda_value).transpose(0, 1)
      returns = (advantages + value_preds[:, :-1]
                 if self.use_td_lambda_return else _returns())
    else:
      returns = _returns()
      advantages = returns - value_preds[:, :-1]
    return returns, advantages

  # -- loss over one (mini)batch of frames -----------------------------------
  def _normalized(self, agent_state, obs):
    if self.obs_normalizer is None:
      return obs
    return self.obs_normalizer.normalize(agent_state.obs_norm_state, obs)

  def _loss(self, agent_state: PPOAgentState, batch):
    """(total, (PPOLossExtra, mean KL)) of one minibatch under the
    state's current networks. `batch` is (obs, step_type, actions,
    old_dist, old_values, returns, advantages, old_log_prob, mask)."""
    obs, step_type, actions, old_dist, old_values, returns, advantages, \
        old_log_prob, mask = batch
    obs = self._normalized(agent_state, obs)
    dist, _ = agent_state.actor_network(obs, step_type, ())
    values, _ = agent_state.value_network(obs, step_type, ())

    ratio = torch.exp(common.log_probability(dist, actions) - old_log_prob)
    clipping = self.importance_ratio_clipping
    if clipping > 0.0:
      clipped_ratio = torch.clamp(ratio, 1.0 - clipping, 1.0 + clipping)
      pg_per_example = -torch.minimum(ratio * advantages,
                                      clipped_ratio * advantages)
    else:
      # The plain surrogate: min() with a degenerate clip at 1 would zero
      # the gradient of about half the samples.
      pg_per_example = -ratio * advantages
    denom = torch.clamp(mask.sum(), min=1.0)
    pg_loss = torch.sum(pg_per_example * mask) / denom
    clip_fraction = torch.sum(
        (torch.abs(ratio - 1.0) > clipping).float() * mask) / denom

    if self.value_clipping is not None:
      clipped_values = old_values + torch.clamp(
          values - old_values, -self.value_clipping, self.value_clipping)
      value_error = torch.maximum(torch.square(returns - values),
                                  torch.square(returns - clipped_values))
    else:
      value_error = torch.square(returns - values)
    value_loss = self.value_pred_loss_coef * torch.sum(
        value_error * mask) / denom

    zero = torch.zeros((), device=mask.device)
    entropy_loss = zero
    if self.entropy_regularization > 0:
      entropy_loss = -self.entropy_regularization * torch.sum(
          common.entropy(dist) * mask) / denom

    kl = _kl(old_dist, dist)
    mean_kl = torch.sum(kl * mask) / denom
    kl_penalty = zero
    if self.kl_cutoff_factor > 0:
      cutoff = self.kl_cutoff_factor * self.adaptive_kl_target
      kl_penalty = kl_penalty + self.kl_cutoff_coef * torch.sum(
          torch.square(torch.clamp(kl - cutoff, min=0.0)) * mask) / denom
    kl_penalty = kl_penalty + agent_state.kl_beta * mean_kl

    total = pg_loss + value_loss + entropy_loss + kl_penalty
    extra = PPOLossExtra(
        policy_gradient_loss=pg_loss, value_estimation_loss=value_loss,
        entropy_reg_loss=entropy_loss, kl_penalty_loss=kl_penalty,
        clip_fraction=clip_fraction)
    return total, (extra, mean_kl)

  # -- train -----------------------------------------------------------------
  def train(self, agent_state: PPOAgentState, experience, weights=None,
            draws=None) -> Tuple[PPOAgentState, LossInfo]:
    """experience: Trajectory [B, T] from the PPO collect policy."""
    draws = draws if draws is not None else agent_state.draws
    with torch.no_grad():
      # 1) The normalizers take the fresh rollout first.
      if self.obs_normalizer is not None:
        agent_state = dataclasses.replace(
            agent_state, obs_norm_state=self.obs_normalizer.update(
                agent_state.obs_norm_state, experience.observation))
      if self.reward_normalizer is not None:
        agent_state = dataclasses.replace(
            agent_state, reward_norm_state=self.reward_normalizer.update(
                agent_state.reward_norm_state, experience.reward))

      # 2) Advantages and returns from the collect-time values.
      returns, advantages = self.compute_return_and_advantage(
          agent_state, experience)

      # 3) The window [:, :-1] as B * (T - 1) frames; boundary frames are
      #    masked.
      b, t = experience.discount.shape
      n_items = b * (t - 1)
      window = lambda x: nest_utils.tree_map(  # noqa: E731
          lambda v: v[:, :-1].reshape((n_items,) + tuple(v.shape[2:])), x)
      obs = window(experience.observation)
      step_type = window(experience.step_type)
      actions = window(experience.action)
      old_dist = window(experience.policy_info["dist"])
      old_values = window(experience.policy_info["value_prediction"])
      returns = returns.reshape(n_items)
      advantages = advantages.reshape(n_items)
      mask = (step_type != ts.StepType.LAST).float()
      if weights is not None:
        mask = mask * weights[:, None].expand(b, t - 1).reshape(-1)
      old_log_prob = common.log_probability(old_dist, actions)

      if self.normalize_advantages:
        denom = torch.clamp(mask.sum(), min=1.0)
        adv_mean = torch.sum(advantages * mask) / denom
        adv_var = torch.sum(torch.square(advantages - adv_mean) * mask) / denom
        advantages = (advantages - adv_mean) / (torch.sqrt(adv_var) + 1e-8)

    n_mb = self.num_minibatches
    if n_items % n_mb:
      raise ValueError(f"{n_items} frames do not split into {n_mb} "
                       "minibatches")
    size = n_items // n_mb
    flat_batch = (obs, step_type, actions, old_dist, old_values, returns,
                  advantages, old_log_prob, mask)
    params = [p for group in agent_state.optimizer.param_groups
              for p in group["params"]]
    for _ in range(self.num_epochs):
      perm = draws.permutation(PERMUTATION_SITE, n_items)
      shuffled = nest_utils.tree_map(lambda x: x[perm], flat_batch)
      for m in range(n_mb):
        mb = nest_utils.tree_map(lambda x: x[m * size:(m + 1) * size],
                                 shuffled)
        loss, (extra, mean_kl) = self._loss(agent_state, mb)
        grads = torch.autograd.grad(loss, params)
        if self.gradient_clipping is not None:
          common.clip_gradient_norms(grads, self.gradient_clipping)
        for p, g in zip(params, grads):
          p.grad = g
        agent_state.optimizer.step()
        if agent_state.lr_scheduler is not None:
          agent_state.lr_scheduler.step()

    # 4) Adaptive beta from the KL of the full batch under the final policy.
    kl_beta = agent_state.kl_beta
    if self.initial_adaptive_kl_beta > 0:
      with torch.no_grad():
        dist_f, _ = agent_state.actor_network(
            self._normalized(agent_state, obs), step_type, ())
        denom_f = torch.clamp(mask.sum(), min=1.0)
        mean_kl = torch.sum(_kl(old_dist, dist_f) * mask) / denom_f
        too_high = mean_kl > self.adaptive_kl_target * (
            1.0 + self.adaptive_kl_tolerance)
        too_low = mean_kl < self.adaptive_kl_target * (
            1.0 - self.adaptive_kl_tolerance)
        kl_beta = torch.where(too_high, kl_beta * 1.5,
                              torch.where(too_low, kl_beta / 1.5, kl_beta))

    extra = PPOLossExtra(**{f.name: getattr(extra, f.name).detach()
                            for f in dataclasses.fields(extra)})
    new_state = dataclasses.replace(agent_state, kl_beta=kl_beta,
                                    train_step=agent_state.train_step + 1)
    return new_state, LossInfo(loss=loss.detach(), extra=extra)
