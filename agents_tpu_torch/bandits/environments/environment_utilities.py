"""Reward-function generators and optimality helpers for bandit suites.

Port of ``agents_tpu/bandits/environments/environment_utilities.py``.
Reward callables take ``(x, draws=None)``: given a draw source they add
Gaussian noise drawn at the site "linear_reward_noise" (the JAX package's
"was a key given"). Parameters live on `device` ("cuda" unless the caller
asks for "cpu").
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from agents_tpu_torch.utils.device import resolve_device

REWARD_NOISE_SITE = "linear_reward_noise"


class LinearNormalReward:
  """r(x) = thetaᵀx (+ zero-mean noise of VARIANCE sigma when draws are
  given; the code scales by sqrt(sigma))."""

  def __init__(self, theta, sigma: float = 0.0, device="cuda"):
    self.theta = torch.as_tensor(np.asarray(theta, np.float32),
                                 device=resolve_device(device))
    self.sigma = float(sigma)

  def __call__(self, x, draws=None):
    mu = torch.einsum("...d,d->...", x.float(), self.theta)
    if draws is None or self.sigma == 0.0:
      return mu
    return mu + self.sigma ** 0.5 * draws.normal(REWARD_NOISE_SITE, mu.shape)


def linear_reward_fn_generator(theta_list, variance: float, device="cuda"):
  return [LinearNormalReward(theta, variance, device) for theta in theta_list]


def sliding_linear_reward_fn_generator(context_dim: int, num_actions: int,
                                       variance: float, device="cuda"):
  """Action k's parameter is the consecutive integers [k, .., k+d-1]."""
  return linear_reward_fn_generator(
      [np.arange(i, i + context_dim, dtype=np.float32)
       for i in range(num_actions)], variance, device)


def normalized_sliding_linear_reward_fn_generator(context_dim: int,
                                                  num_actions: int,
                                                  variance: float,
                                                  device="cuda"):
  """Same, scaled by 1/(context_dim + num_actions)."""
  norm = float(context_dim + num_actions)
  return linear_reward_fn_generator(
      [np.arange(i, i + context_dim, dtype=np.float32) / norm
       for i in range(num_actions)], variance, device)


def structured_linear_reward_fn_generator(context_dim: int, num_actions: int,
                                          variance: float,
                                          drift_coefficient: float = 0.1,
                                          seed: int = 0, device="cuda"):
  """theta_{k+1} = theta_k + drift_coefficient * U[0,1)^d, from numpy's
  `default_rng(seed)` as in the JAX package."""
  rng = np.random.default_rng(seed)
  theta = rng.random(context_dim).astype(np.float32)
  thetas = [theta]
  for _ in range(1, num_actions):
    theta = theta + drift_coefficient * rng.random(context_dim).astype(
        np.float32)
    thetas.append(theta)
  return linear_reward_fn_generator(thetas, variance, device)


class LinearNormalMultipleRewards:
  """Stacked linear objectives for multi-objective bandits: [..., m] per
  context."""

  def __init__(self, thetas, sigma: float = 0.0, device="cuda"):
    self.thetas = torch.as_tensor(np.asarray(thetas, np.float32),
                                  device=resolve_device(device))  # [m, d]
    self.sigma = float(sigma)

  def __call__(self, x, draws=None):
    mu = torch.einsum("...d,md->...m", x.float(), self.thetas)
    if draws is None or self.sigma == 0.0:
      return mu
    return mu + self.sigma ** 0.5 * draws.normal(REWARD_NOISE_SITE, mu.shape)


class _Repeat:
  """A draw source that hands every caller the same normal draw."""

  def __init__(self, draws):
    self.draws = draws
    self.value = None

  def normal(self, site, shape, dtype=torch.float32):
    if self.value is None:
      self.value = self.draws.normal(site, shape, dtype)
    return self.value


def stack_reward_fns(reward_fns: Sequence[Callable]):
  """[K callables] -> one fn(observation[, draws]) -> [..., K] rewards.

  Like the JAX package, which hands every arm the same key, every arm
  sees the same noise draw."""
  def all_arms(observation, draws=None):
    shared = None if draws is None else _Repeat(draws)
    return torch.stack([fn(observation) if shared is None
                        else fn(observation, shared) for fn in reward_fns],
                       dim=-1)
  return all_arms


def compute_optimal_reward(observation, reward_fns: Sequence[Callable]):
  """Noise-free max over arms."""
  return torch.max(stack_reward_fns(reward_fns)(observation), dim=-1).values


def compute_optimal_action(observation, reward_fns: Sequence[Callable],
                           dtype=torch.int32):
  """Noise-free argmax over arms."""
  return torch.argmax(stack_reward_fns(reward_fns)(observation),
                      dim=-1).to(dtype)


def build_laplacian_over_ordinal_integer_actions(action_spec,
                                                 device="cuda"
                                                 ) -> torch.Tensor:
  """Path-graph Laplacian over ordinal actions: actions k and k±1 are
  neighbors."""
  num_actions = int(action_spec.maximum) - int(action_spec.minimum) + 1
  adj = np.zeros((num_actions, num_actions), np.float32)
  idx = np.arange(num_actions - 1)
  adj[idx, idx + 1] = 1.0
  adj[idx + 1, idx] = 1.0
  lap = np.diag(adj.sum(axis=1)) - adj
  return torch.as_tensor(lap, device=resolve_device(device))


def context_sampling_fn(context_dim: int, low: int = -10, high: int = 10):
  """Uniform integer contexts as float32, as a sampler
  ``(draws, batch_shape) -> [*batch_shape, context_dim]`` at the site
  "context_sampling"."""
  def sample(draws, batch_shape=()):
    return draws.randint("context_sampling",
                         tuple(batch_shape) + (context_dim,), low,
                         high).to(torch.float32)
  return sample
