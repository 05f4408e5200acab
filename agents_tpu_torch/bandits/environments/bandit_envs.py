"""Batched on-device bandit environments (length-1 episodes).

Port of ``agents_tpu/bandits/environments/bandit_envs.py``:
`BanditTorchEnvironment` (the JAX package's `BanditJaxEnvironment`),
`StationaryStochasticBandit`, `DriftingLinearBandit`, `BernoulliBandit`,
`WheelBandit`, `ClassificationBandit` and `RandomBandit`. Each env is
written for a leading batch dim; its constants live on `device` ("cuda"
unless the caller asks for "cpu"). Each env exposes
`optimal_reward_fn(observation)` (and most `optimal_action_fn`) for the
regret metrics.

Draw sites (`agents_tpu_torch.utils.draws`):
  "bandit_context"       uniform [B, d] in [low, high)  (stationary and
                                                         drifting contexts)
  "bandit_reward_noise"  normal [B]                     (their reward noise,
                                                         the wheel's and
                                                         the random
                                                         bandit's reward)
  "bandit_bernoulli"     uniform [B]                    (Bernoulli rewards)
  "wheel_context"        uniform [R, B, 2] in [-1, 1)   (the wheel's R
                                                         candidate contexts)
  "classification_index" randint [B] in [0, N)          (the dataset row)
  "random_bandit_context" normal [B, d]
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from agents_tpu_torch.environments.torch_environment import TorchEnvironment
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device

# Candidate rounds of the wheel's rejection sampler. Each candidate falls
# outside the unit disk with probability 1 - pi/4, so a row is left
# unfilled with probability (1 - pi/4)**R (about 2.1e-11 at R = 16); such
# a row takes its last candidate scaled onto the unit circle.
WHEEL_CANDIDATES = 16


@dataclasses.dataclass(frozen=True)
class BanditState:
  context: Any
  round: torch.Tensor  # [B] int32 round counter (for drifting envs)


def _zeros_like_spec(spec_nest, batch_size, device):
  return nest_utils.tree_map(
      lambda s: torch.zeros((batch_size,) + tuple(s.shape),
                            dtype=array_spec.torch_dtype(s.dtype),
                            device=device),
      spec_nest, is_leaf=array_spec._is_spec)


def _first_leaf(nest):
  return nest_utils.flatten(nest)[0]


class BanditTorchEnvironment(TorchEnvironment):
  """One-round episodes: reset -> FIRST(context); step -> LAST(reward).

  Subclasses define `_sample_context(draws, round_)` (the [B] round
  counter gives the batch) and `_reward(context, action, draws, round_)`;
  `_observation(context)` is what the agent sees of a context (itself by
  default)."""

  def _sample_context(self, draws, round_):
    raise NotImplementedError

  def _reward(self, context, action, draws, round_):
    raise NotImplementedError

  def _observation(self, context):
    return context

  def optimal_reward_fn(self, observation):
    """Expected reward of the best arm given the observation."""
    raise NotImplementedError

  def optimal_action_fn(self, observation):
    raise NotImplementedError

  def _restart(self, context):
    batch = _first_leaf(context).shape[0]
    device = _first_leaf(context).device
    return ts.TimeStep(
        step_type=torch.full((batch,), ts.StepType.FIRST, dtype=torch.int32,
                             device=device),
        reward=_zeros_like_spec(self.reward_spec(), batch, device),
        discount=torch.ones((batch,), dtype=torch.float32, device=device),
        observation=self._observation(context))

  def reset(self, draws, batch_size: int):
    round_ = torch.zeros((batch_size,), dtype=torch.int32,
                         device=draws.device)
    context = self._sample_context(draws, round_)
    return BanditState(context=context, round=round_), self._restart(context)

  def auto_reset(self, state: BanditState, draws):
    """The between-episode reset of `BatchedTorchEnv`: `step` already
    staged the next round's context and round counter in `state`, so
    rewinding to `reset` (round 0) would freeze every non-stationary env
    at t=0."""
    del draws
    return state, self._restart(state.context)

  def step(self, state: BanditState, action, draws):
    reward = self._reward(state.context, action, draws, state.round)
    new_context = self._sample_context(draws, state.round + 1)
    reward = nest_utils.tree_map(lambda r: r.to(torch.float32), reward)
    batch = state.round.shape[0]
    device = state.round.device
    # LAST with the observation of the round just played; the next FIRST
    # (auto-reset) carries the new context.
    return BanditState(context=new_context, round=state.round + 1), \
        ts.TimeStep(
            step_type=torch.full((batch,), ts.StepType.LAST,
                                 dtype=torch.int32, device=device),
            reward=reward,
            discount=torch.zeros((batch,), dtype=torch.float32,
                                 device=device),
            observation=self._observation(state.context))


def _gather_rows(table, action):
  """table[action[b]] for each row: [K, ...] -> [B, ...]."""
  return table[action.long()]


class StationaryStochasticBandit(BanditTorchEnvironment):
  """Linear payoffs r = thetaᵀx + N(0, noise_std)."""

  def __init__(self, arm_parameters, context_dim: Optional[int] = None,
               noise_std: float = 0.1, context_low=-1.0, context_high=1.0,
               device="cuda"):
    self.device = resolve_device(device)
    self.theta = torch.as_tensor(np.asarray(arm_parameters, np.float32),
                                 device=self.device)  # [K, d]
    self.num_arms, self.context_dim = self.theta.shape
    self.noise_std = noise_std
    self.context_low = context_low
    self.context_high = context_high

  def observation_spec(self):
    return array_spec.BoundedArraySpec(
        (self.context_dim,), np.float32, self.context_low,
        self.context_high, "observation")

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0, self.num_arms - 1,
                                       "action")

  def _sample_context(self, draws, round_):
    return draws.uniform("bandit_context",
                         (round_.shape[0], self.context_dim),
                         self.context_low, self.context_high)

  def _noise(self, draws, batch):
    return self.noise_std * draws.normal("bandit_reward_noise", (batch,))

  def _reward(self, context, action, draws, round_):
    mean = torch.sum(_gather_rows(self.theta, action) * context, dim=-1)
    return mean + self._noise(draws, mean.shape[0])

  def expected_rewards(self, observation):
    return torch.einsum("...d,kd->...k", observation, self.theta)

  def optimal_reward_fn(self, observation):
    return torch.max(self.expected_rewards(observation), dim=-1).values

  def optimal_action_fn(self, observation):
    return torch.argmax(self.expected_rewards(observation), dim=-1)


class DriftingLinearBandit(StationaryStochasticBandit):
  """Arm parameters rotate by drift_rate radians a round in the plane of
  the first two context dims."""

  def __init__(self, arm_parameters, drift_rate: float = 0.01, **kwargs):
    super().__init__(arm_parameters, **kwargs)
    self.drift_rate = drift_rate

  def _reward(self, context, action, draws, round_):
    # (theta R)[a] · x = theta[a] · (R x), R the rotation at round_.
    angle = self.drift_rate * round_.to(torch.float32)
    c, s = torch.cos(angle), torch.sin(angle)
    x0, x1 = context[:, 0], context[:, 1]
    rotated = torch.cat([(c * x0 - s * x1)[:, None],
                         (s * x0 + c * x1)[:, None], context[:, 2:]], dim=1)
    mean = torch.sum(_gather_rows(self.theta, action) * rotated, dim=-1)
    return mean + self._noise(draws, mean.shape[0])


class BernoulliBandit(BanditTorchEnvironment):
  """Context-free Bernoulli arms."""

  def __init__(self, means, device="cuda"):
    self.device = resolve_device(device)
    self.means = torch.as_tensor(np.asarray(means, np.float32),
                                 device=self.device)
    self.num_arms = self.means.shape[0]

  def observation_spec(self):
    return array_spec.BoundedArraySpec((1,), np.float32, 0.0, 1.0,
                                       "observation")

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0, self.num_arms - 1,
                                       "action")

  def _sample_context(self, draws, round_):
    return torch.ones((round_.shape[0], 1), dtype=torch.float32,
                      device=round_.device)

  def _reward(self, context, action, draws, round_):
    u = draws.uniform("bandit_bernoulli", (action.shape[0],))
    return (u < _gather_rows(self.means, action)).to(torch.float32)

  def optimal_reward_fn(self, observation):
    return torch.max(self.means).expand(observation.shape[:-1])

  def optimal_action_fn(self, observation):
    return torch.argmax(self.means).expand(observation.shape[:-1])


class WheelBandit(BanditTorchEnvironment):
  """Riquelme et al.'s wheel bandit: contexts uniform in the unit disk;
  arm 0 safe; arms 1-4 pay a high mean only in their quadrant when
  ||x|| > delta.

  The JAX package draws each context by a `while_loop` of rejections. A
  device loop whose condition is read on the host syncs every round, so
  here every row draws `WHEEL_CANDIDATES` candidates at once and keeps
  its first inside the disk (see `WHEEL_CANDIDATES` for the rows left
  unfilled)."""

  def __init__(self, delta: float = 0.5, mu_inside: float = 1.0,
               mu_high: float = 50.0, mu_low: float = 1.0,
               noise_std: float = 0.01, device="cuda"):
    self.device = resolve_device(device)
    self.delta = delta
    self.mu_inside = mu_inside
    self.mu_high = mu_high
    self.mu_low = mu_low
    self.noise_std = noise_std
    # quadrant (x>=0) + 2 (y>=0) -> arm: (-,-)->3, (+,-)->2, (-,+)->4,
    # (+,+)->1
    self._arm_for_quadrant = torch.tensor([3, 2, 4, 1], device=self.device)

  def observation_spec(self):
    return array_spec.BoundedArraySpec((2,), np.float32, -1.0, 1.0,
                                       "observation")

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0, 4, "action")

  def _sample_context(self, draws, round_):
    batch = round_.shape[0]
    cand = draws.uniform("wheel_context", (WHEEL_CANDIDATES, batch, 2),
                         -1.0, 1.0)
    inside = torch.sum(cand * cand, dim=-1) <= 1.0             # [R, B]
    first = torch.argmax(inside.to(torch.int32), dim=0)        # [B]
    rows = torch.arange(batch, device=cand.device)
    chosen = cand[first, rows]
    last = cand[-1]
    onto_circle = last / torch.sqrt(torch.sum(last * last, -1,
                                              keepdim=True))
    return torch.where(inside.any(dim=0)[:, None], chosen, onto_circle)

  def _mean_rewards(self, context):
    norm = torch.sqrt(torch.sum(context * context, dim=-1))
    outside = norm > self.delta
    quadrant = ((context[..., 0] >= 0).long()
                + 2 * (context[..., 1] >= 0).long())
    hot_arm = self._arm_for_quadrant[quadrant]
    means = torch.full(norm.shape + (5,), self.mu_low,
                       device=context.device)
    means[..., 0] = self.mu_inside
    hot = torch.nn.functional.one_hot(hot_arm, 5).bool() & outside[..., None]
    return torch.where(hot, self.mu_high, means)

  def _reward(self, context, action, draws, round_):
    mean = torch.gather(self._mean_rewards(context), -1,
                        action.long()[:, None])[:, 0]
    return mean + self.noise_std * draws.normal("bandit_reward_noise",
                                                mean.shape)

  def optimal_reward_fn(self, observation):
    return torch.max(self._mean_rewards(observation), dim=-1).values

  def optimal_action_fn(self, observation):
    return torch.argmax(self._mean_rewards(observation), dim=-1)


class ClassificationBandit(BanditTorchEnvironment):
  """Supervised dataset -> bandit: context = a row's features, reward =
  reward_table[label, action].

  The JAX package hides the row index as a float32 in an extra context
  slot (exact up to 2**24 rows); here the context carries it as an int64
  beside the features, and the agent sees the features alone."""

  def __init__(self, features, labels, reward_table, reward_sampler=None,
               device="cuda"):
    """reward_table: [num_classes, num_actions] expected rewards.
    reward_sampler: optional ``(label, action, draws) -> reward`` for
    stochastic rewards (e.g. `dataset_utilities.mushroom_reward_sampler`);
    when given, it replaces the table lookup for the realized reward and
    the table is its expectation."""
    self.device = resolve_device(device)
    self.features = torch.as_tensor(np.asarray(features, np.float32),
                                    device=self.device)  # [N, d]
    self.labels = torch.as_tensor(np.asarray(labels, np.int64),
                                  device=self.device)    # [N]
    self.reward_table = torch.as_tensor(
        np.asarray(reward_table, np.float32), device=self.device)  # [C, K]
    self.reward_sampler = reward_sampler
    self.n = self.features.shape[0]

  def observation_spec(self):
    return array_spec.ArraySpec((self.features.shape[1],), np.float32,
                                "observation")

  def action_spec(self):
    return array_spec.BoundedArraySpec(
        (), np.int32, 0, self.reward_table.shape[1] - 1, "action")

  def _sample_context(self, draws, round_):
    idx = draws.randint("classification_index", (round_.shape[0],), 0,
                        self.n)
    return {"features": self.features[idx], "index": idx}

  def _observation(self, context):
    return context["features"]

  def _reward(self, context, action, draws, round_):
    label = self.labels[context["index"]]
    if self.reward_sampler is not None:
      return self.reward_sampler(label, action, draws)
    return self.reward_table[label, action.long()]

  def optimal_reward_fn(self, observation):
    # The label is not observable: the table max bounds the reward.
    return torch.max(self.reward_table).expand(observation.shape[:-1])


class RandomBandit(BanditTorchEnvironment):
  """Gaussian contexts and rewards."""

  def __init__(self, context_dim: int = 4, num_arms: int = 3,
               device="cuda"):
    self.device = resolve_device(device)
    self.context_dim = context_dim
    self.num_arms = num_arms

  def observation_spec(self):
    return array_spec.ArraySpec((self.context_dim,), np.float32,
                                "observation")

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0, self.num_arms - 1,
                                       "action")

  def _sample_context(self, draws, round_):
    return draws.normal("random_bandit_context",
                        (round_.shape[0], self.context_dim))

  def _reward(self, context, action, draws, round_):
    return draws.normal("bandit_reward_noise", (action.shape[0],))

  def optimal_reward_fn(self, observation):
    return torch.zeros(observation.shape[:-1], device=observation.device)
