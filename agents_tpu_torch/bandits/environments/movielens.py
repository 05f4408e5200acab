"""MovieLens bandit environments via SVD matrix factorization.

Port of ``agents_tpu/bandits/environments/movielens.py``: the ratings
matrix is factorized once on the host (numpy SVD); contexts and rewards
are then device functions of the factor matrices. The matrix is given
directly (for example `synthetic_ratings_matrix`) or parsed from the
MovieLens-100K csv by `load_movielens_data`; no dataset is downloaded.

Draw sites: "movielens_user" randint [B] in [0, num_users);
"movielens_movies" uniform [B, num_movies] (per-arm env: each row's
movies are the `num_actions` smallest of its uniforms, a uniformly
random sample without replacement, as the JAX package's per-row
`permutation`).
"""
from __future__ import annotations

import csv
from typing import Optional

import numpy as np
import torch

from agents_tpu_torch.bandits.environments.bandit_envs import (
    BanditTorchEnvironment)
from agents_tpu_torch.bandits.specs.bandit_spec_utils import (
    GLOBAL_FEATURE_KEY, PER_ARM_FEATURE_KEY)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils.device import resolve_device

MOVIELENS_NUM_USERS = 943
MOVIELENS_NUM_MOVIES = 1682


def load_movielens_data(data_file: str, delimiter: str = ",") -> np.ndarray:
  """Parses the MovieLens-100K ratings csv (rows: user|item|rating|ts)
  into a dense [num_users, num_movies] matrix."""
  ratings = np.zeros([MOVIELENS_NUM_USERS, MOVIELENS_NUM_MOVIES])
  with open(data_file, "r") as infile:
    for row in csv.reader(infile, delimiter=delimiter):
      user_id, item_id, rating, _ = row
      ratings[int(user_id) - 1, int(item_id) - 1] = float(rating)
  return ratings


def synthetic_ratings_matrix(num_users: int, num_movies: int, rank: int,
                             seed: int = 0, sparsity: float = 0.5
                             ) -> np.ndarray:
  """Low-rank synthetic stand-in for the MovieLens matrix; ratings in
  [0, 5] with zeroed-out entries (numpy's `RandomState(seed)`, so both
  packages make the same matrix)."""
  rng = np.random.RandomState(seed)
  u = rng.uniform(0.0, 1.0, size=(num_users, rank))
  v = rng.uniform(0.0, 1.0, size=(rank, num_movies))
  ratings = 5.0 * (u @ v) / rank
  mask = rng.uniform(size=ratings.shape) < sparsity
  return np.where(mask, ratings, 0.0)


def _matrix(data_matrix, data_path, csv_delimiter):
  if data_matrix is None:
    if data_path is None:
      raise ValueError("Provide data_matrix or data_path")
    data_matrix = load_movielens_data(data_path, csv_delimiter)
  return np.asarray(data_matrix, np.float64)


class MovieLensBandit(BanditTorchEnvironment):
  """Global-context MovieLens bandit: observation = the user's rank-k
  factor vector; reward for movie j = the rank-k approximation of the
  user's rating of j (deterministic given the sampled user)."""

  def __init__(self, data_matrix: Optional[np.ndarray] = None,
               data_path: Optional[str] = None, rank_k: int = 2,
               num_movies: int = 20, csv_delimiter: str = ",",
               device="cuda"):
    self.device = resolve_device(device)
    data_matrix = _matrix(data_matrix, data_path,
                          csv_delimiter)[:, :num_movies]
    # Drop users with no rating among the kept movies.
    data_matrix = data_matrix[np.sum(data_matrix, axis=1) > 0.0]
    self.num_users = data_matrix.shape[0]
    self.num_actions = num_movies
    self.context_dim = rank_k

    u, s, vh = np.linalg.svd(data_matrix, full_matrices=False)
    # A ~= (u sqrt(s)) (sqrt(s) vh): the observation carries u_hat, the
    # reward is a dot product with v_hat.
    self._u_hat = torch.as_tensor(
        (u[:, :rank_k] * np.sqrt(s[:rank_k])).astype(np.float32),
        device=self.device)                                    # [Nu, k]
    self._v_hat = torch.as_tensor(
        (np.sqrt(s[:rank_k])[:, None] * vh[:rank_k]).astype(np.float32),
        device=self.device)                                    # [k, M]

  def observation_spec(self):
    return array_spec.ArraySpec((self.context_dim,), np.float32,
                                "observation")

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0,
                                       self.num_actions - 1, "action")

  def _sample_context(self, draws, round_):
    user = draws.randint("movielens_user", (round_.shape[0],), 0,
                         self.num_users)
    return self._u_hat[user]

  def _reward(self, context, action, draws, round_):
    return torch.sum(context * self._v_hat[:, action.long()].T, dim=-1)

  def expected_rewards(self, observation):
    return torch.einsum("...k,km->...m", observation, self._v_hat)

  def optimal_reward_fn(self, observation):
    return torch.max(self.expected_rewards(observation), dim=-1).values

  def optimal_action_fn(self, observation):
    return torch.argmax(self.expected_rewards(observation), dim=-1)


class MovieLensPerArmBandit(BanditTorchEnvironment):
  """Per-arm MovieLens bandit: observation = {global: user factors [k],
  per_arm: movie factors [num_actions, k]} over a fresh
  without-replacement movie sample each round; reward = u s vᵀ."""

  def __init__(self, data_matrix: Optional[np.ndarray] = None,
               data_path: Optional[str] = None, rank_k: int = 2,
               num_actions: int = 10, csv_delimiter: str = ",",
               device="cuda"):
    self.device = resolve_device(device)
    data_matrix = _matrix(data_matrix, data_path, csv_delimiter)
    self.num_users, self.num_movies = data_matrix.shape
    self.num_actions = num_actions
    self.context_dim = rank_k

    u, s, vh = np.linalg.svd(data_matrix, full_matrices=False)
    as_t = lambda x: torch.as_tensor(x.astype(np.float32),  # noqa: E731
                                     device=self.device)
    self._u_hat = as_t(u[:, :rank_k])                           # [Nu, k]
    self._s_hat = as_t(s[:rank_k])                              # [k]
    self._v_hat = as_t(np.ascontiguousarray(vh[:rank_k].T))    # [M, k]

  def observation_spec(self):
    return {
        GLOBAL_FEATURE_KEY:
            array_spec.ArraySpec((self.context_dim,), np.float32, "global"),
        PER_ARM_FEATURE_KEY:
            array_spec.ArraySpec((self.num_actions, self.context_dim),
                                 np.float32, "per_arm"),
    }

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0,
                                       self.num_actions - 1, "action")

  def _sample_context(self, draws, round_):
    batch = round_.shape[0]
    user = draws.randint("movielens_user", (batch,), 0, self.num_users)
    keys = draws.uniform("movielens_movies", (batch, self.num_movies))
    movies = torch.argsort(keys, dim=-1)[:, :self.num_actions]
    return {GLOBAL_FEATURE_KEY: self._u_hat[user],
            PER_ARM_FEATURE_KEY: self._v_hat[movies]}

  def _reward(self, context, action, draws, round_):
    arms = context[PER_ARM_FEATURE_KEY]
    arm = torch.gather(arms, 1, action.long()[:, None, None].expand(
        -1, 1, arms.shape[-1]))[:, 0]
    return torch.sum(context[GLOBAL_FEATURE_KEY] * self._s_hat * arm, dim=-1)

  def expected_rewards(self, observation):
    return torch.einsum("...k,...mk->...m",
                        observation[GLOBAL_FEATURE_KEY] * self._s_hat,
                        observation[PER_ARM_FEATURE_KEY])

  def optimal_reward_fn(self, observation):
    return torch.max(self.expected_rewards(observation), dim=-1).values

  def optimal_action_fn(self, observation):
    return torch.argmax(self.expected_rewards(observation), dim=-1)
