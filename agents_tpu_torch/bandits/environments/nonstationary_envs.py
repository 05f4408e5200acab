"""Non-stationary bandit environments (batched, length-1 episodes).

Port of ``agents_tpu/bandits/environments/nonstationary_envs.py``:
`NonStationaryStochasticBandit` (dynamics as functions of the round
counter), `PiecewiseBernoulliBandit` and
`PiecewiseStationaryStochasticBandit` (a precompiled round -> piece
table, so a step is one gather). Rounds are `BanditState.round`, which
the base class advances every step and `BatchedTorchEnv`'s auto-reset
keeps.

Draw sites: "bandit_bernoulli" uniform [B] (piecewise Bernoulli rewards),
"bandit_context_normal" normal [B, d] and "bandit_reward_noise" normal
[B] (piecewise linear-Gaussian contexts and rewards).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from agents_tpu_torch.bandits.environments.bandit_envs import (
    BanditTorchEnvironment)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils.device import resolve_device


class NonStationaryStochasticBandit(BanditTorchEnvironment):
  """Generic time-indexed dynamics over a batch:

    observation_fn(draws, round) -> [B, ...] observations
    reward_fn(observation, action, draws, round) -> [B] rewards

  with `round` the [B] round counter. Optional `optimal_reward_fn` /
  `optimal_action_fn` (observation-only, for the regret metrics) and
  `expected_rewards_fn(observation, round)` may be supplied. (The JAX
  package's callables take one row and a PRNG key.)
  """

  def __init__(self,
               observation_spec,
               action_spec,
               observation_fn: Callable,
               reward_fn: Callable,
               optimal_reward_fn: Optional[Callable] = None,
               optimal_action_fn: Optional[Callable] = None,
               expected_rewards_fn: Optional[Callable] = None):
    self._observation_spec = observation_spec
    self._action_spec = action_spec
    self._observation_fn = observation_fn
    self._reward_fn = reward_fn
    self._optimal_reward_fn = optimal_reward_fn
    self._optimal_action_fn = optimal_action_fn
    self._expected_rewards_fn = expected_rewards_fn

  def observation_spec(self):
    return self._observation_spec

  def action_spec(self):
    return self._action_spec

  def _sample_context(self, draws, round_):
    return self._observation_fn(draws, round_)

  def _reward(self, context, action, draws, round_):
    return self._reward_fn(context, action, draws, round_)

  def expected_rewards_at(self, observation, round_):
    if self._expected_rewards_fn is None:
      raise NotImplementedError
    return self._expected_rewards_fn(observation, round_)

  def optimal_reward_fn(self, observation):
    if self._optimal_reward_fn is None:
      raise NotImplementedError
    return self._optimal_reward_fn(observation)

  def optimal_action_fn(self, observation):
    if self._optimal_action_fn is None:
      raise NotImplementedError
    return self._optimal_action_fn(observation)


def piece_schedule(durations: Sequence[int], num_pieces: int,
                   horizon: int) -> np.ndarray:
  """Expands change-point durations into a round -> piece lookup table:
  `table[t]` is the active piece at round t, pieces wrapping modulo
  `num_pieces`. Rounds beyond `horizon` clamp to the final entry."""
  table = np.zeros((horizon,), np.int32)
  t, piece = 0, -1
  i = 0
  while t < horizon:
    d = int(durations[i % len(durations)])
    if d < 0:
      raise ValueError(f"durations must be non-negative, got {d}")
    piece = (piece + 1) % num_pieces
    table[t:t + d] = piece
    t += d
    i += 1
    if d == 0 and i > len(durations) * (horizon + 1):
      raise ValueError("duration schedule makes no progress")
  return table


class _Scheduled:
  """The piece table on the device and its lookup."""

  def _set_schedule(self, durations, num_pieces, horizon):
    self.schedule = torch.as_tensor(
        piece_schedule(durations, num_pieces, horizon), dtype=torch.int64,
        device=self.device)
    self.horizon = horizon

  def _piece(self, round_):
    round_ = torch.as_tensor(round_, device=self.device).long()
    return self.schedule[torch.clamp(round_, max=self.horizon - 1)]


class PiecewiseBernoulliBandit(_Scheduled, BanditTorchEnvironment):
  """Piecewise-stationary Bernoulli arms: piece_means [num_pieces,
  num_arms] in [0, 1], the active piece following `piece_schedule`."""

  def __init__(self, piece_means, durations: Sequence[int],
               horizon: int = 100_000, device="cuda"):
    self.device = resolve_device(device)
    means = np.asarray(piece_means, np.float32)
    if means.ndim != 2:
      raise ValueError("piece_means must be [num_pieces, num_arms]")
    if np.any(means < 0.0) or np.any(means > 1.0):
      raise ValueError("All parameters should be floats in [0, 1].")
    self.piece_means = torch.as_tensor(means, device=self.device)
    self.num_pieces, self.num_arms = means.shape
    self._set_schedule(durations, self.num_pieces, horizon)

  def observation_spec(self):
    return array_spec.ArraySpec((1,), np.int32, "observation")

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0, self.num_arms - 1,
                                       "action")

  def _sample_context(self, draws, round_):
    return torch.zeros((round_.shape[0], 1), dtype=torch.int32,
                       device=round_.device)

  def _reward(self, context, action, draws, round_):
    mean = self.piece_means[self._piece(round_), action.long()]
    u = draws.uniform("bandit_bernoulli", mean.shape)
    return (u < mean).to(torch.float32)

  def means_at(self, round_):
    return self.piece_means[self._piece(round_)]


class PiecewiseStationaryStochasticBandit(_Scheduled, BanditTorchEnvironment):
  """Piecewise linear-Gaussian contextual bandit: per piece p,
  observation ~ N(mu[p], observation_std) elementwise and arm k's reward
  theta[p, k]ᵀ x + N(0, reward_std).

  The JAX package draws (mu, theta) from ``jax.random.key(seed)``; here
  they are standard normals from a `torch.Generator` seeded with `seed`
  on the device (the same distribution). A test that needs the JAX
  package's pieces sets `mu` and `theta`.
  """

  def __init__(self, context_dim: int, num_arms: int, num_pieces: int,
               durations: Sequence[int], seed: int = 0,
               observation_std: float = 1.0, reward_std: float = 0.1,
               horizon: int = 100_000, device="cuda"):
    self.device = resolve_device(device)
    self.context_dim = context_dim
    self.num_arms = num_arms
    self.num_pieces = num_pieces
    generator = torch.Generator(device=self.device)
    generator.manual_seed(int(seed))
    self.mu = torch.randn((num_pieces, context_dim), generator=generator,
                          device=self.device)
    self.theta = torch.randn((num_pieces, num_arms, context_dim),
                             generator=generator, device=self.device)
    self.observation_std = observation_std
    self.reward_std = reward_std
    self._set_schedule(durations, num_pieces, horizon)

  def observation_spec(self):
    return array_spec.ArraySpec((self.context_dim,), np.float32,
                                "observation")

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0, self.num_arms - 1,
                                       "action")

  def _sample_context(self, draws, round_):
    p = self._piece(round_)
    return self.mu[p] + self.observation_std * draws.normal(
        "bandit_context_normal", (round_.shape[0], self.context_dim))

  def _reward(self, context, action, draws, round_):
    p = self._piece(round_)
    mean = torch.sum(self.theta[p, action.long()] * context, dim=-1)
    return mean + self.reward_std * draws.normal("bandit_reward_noise",
                                                 mean.shape)

  def expected_rewards_at(self, observation, round_):
    return torch.einsum("...d,...kd->...k", observation,
                        self.theta[self._piece(round_)])
