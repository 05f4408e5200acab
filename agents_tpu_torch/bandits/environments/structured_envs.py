"""Per-arm-feature, action-masked and ranking bandit environments.

Port of ``agents_tpu/bandits/environments/structured_envs.py``:
`StationaryStochasticPerArmBandit`, `BernoulliActionMaskBandit`,
`RankingBanditEnv` (with `FeedbackModel`, `ClickModel` and
`cascading_to_score_vector`) and `ExplicitPositionalBiasRankingEnv`.

The JAX package's user callables take one PRNG key and are vmapped per
arm or item; here they take ``(draws, batch_shape)`` and return the whole
batch:
  global_sampling_fn(draws, (B,)) -> [B, g]
  arm_sampling_fn / item_sampling_fn(draws, (B, K)) -> [B, K, a]
  num_actions_fn(draws, (B,)) -> [B]
  reward_fn(x [B, g + a], draws) -> [B]; expected_reward_fn(x [..., g + a])
  relevance_fn(global [B, g], items [B, S, i]) -> [B, S]

Draw sites: "action_mask" uniform [B, K] and "action_mask_fix" randint [B]
in [0, K) (the mask and the arm enabled where it is all zero);
"ranking_perturb" normal [B, S + i] and "ranking_choice" uniform
[B, S + i] in [tiny, 1) (the ghost-action click: score noise, then the
Gumbel noise of ``jax.random.categorical``); "ranking_click" uniform
[B, S] (positional-bias clicks).
"""
from __future__ import annotations

import enum
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from agents_tpu_torch import distributions as dist_lib
from agents_tpu_torch.bandits.environments.bandit_envs import (
    BanditTorchEnvironment)
from agents_tpu_torch.bandits.specs.bandit_spec_utils import (
    GLOBAL_FEATURE_KEY, NUM_ACTIONS_FEATURE_KEY, PER_ARM_FEATURE_KEY)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils.device import resolve_device


def _take_arms(arms, action):
  """arms[b, action[b]] for [B, K, a] arms and [B] or [B, S] actions."""
  index = action.long()
  if index.dim() == 1:
    return torch.gather(arms, 1, index[:, None, None].expand(
        -1, 1, arms.shape[-1]))[:, 0]
  return torch.gather(arms, 1, index[..., None].expand(
      -1, -1, arms.shape[-1]))


class StationaryStochasticPerArmBandit(BanditTorchEnvironment):
  """Global + per-arm features; reward on the chosen arm's features.

  observation = {global: [g], per_arm: [K, a]} (+ num_actions for
  variable arm counts, a third key: the dict is then in sorted-key order,
  as `create_per_arm_observation_spec` makes it), reward =
  reward_fn(concat(global, per_arm[action]), draws). `expected_reward_fn`
  (noise-free) powers the optimal reward and action; arms beyond
  num_actions are masked out of the optimum.
  """

  def __init__(self,
               global_sampling_fn: Callable,
               arm_sampling_fn: Callable,
               reward_fn: Callable,
               global_dim: int,
               arm_dim: int,
               max_num_actions: int,
               num_actions_fn: Optional[Callable] = None,
               expected_reward_fn: Optional[Callable] = None):
    self.global_sampling_fn = global_sampling_fn
    self.arm_sampling_fn = arm_sampling_fn
    self.reward_fn = reward_fn
    self.global_dim = global_dim
    self.arm_dim = arm_dim
    self.max_num_actions = max_num_actions
    self.num_actions_fn = num_actions_fn
    self.expected_reward_fn = expected_reward_fn

  def observation_spec(self):
    spec = {
        GLOBAL_FEATURE_KEY:
            array_spec.ArraySpec((self.global_dim,), np.float32, "global"),
        PER_ARM_FEATURE_KEY:
            array_spec.ArraySpec((self.max_num_actions, self.arm_dim),
                                 np.float32, "per_arm"),
    }
    if self.num_actions_fn is not None:
      spec[NUM_ACTIONS_FEATURE_KEY] = array_spec.BoundedArraySpec(
          (), np.int32, 1, self.max_num_actions, "num_actions")
    return dict(sorted(spec.items()))

  def action_spec(self):
    return array_spec.BoundedArraySpec((), np.int32, 0,
                                       self.max_num_actions - 1, "action")

  def _sample_context(self, draws, round_):
    batch = round_.shape[0]
    obs = {
        GLOBAL_FEATURE_KEY: self.global_sampling_fn(draws, (batch,)),
        PER_ARM_FEATURE_KEY: self.arm_sampling_fn(
            draws, (batch, self.max_num_actions)),
    }
    if self.num_actions_fn is not None:
      n = torch.clamp(self.num_actions_fn(draws, (batch,)), 1,
                      self.max_num_actions)
      obs[NUM_ACTIONS_FEATURE_KEY] = n.to(torch.int32)
    return dict(sorted(obs.items()))

  def _reward(self, context, action, draws, round_):
    x = torch.cat([context[GLOBAL_FEATURE_KEY],
                   _take_arms(context[PER_ARM_FEATURE_KEY], action)], dim=-1)
    return self.reward_fn(x, draws)

  def _expected_all_arms(self, observation):
    g = observation[GLOBAL_FEATURE_KEY]
    arms = observation[PER_ARM_FEATURE_KEY]
    x = torch.cat([g[..., None, :].expand(arms.shape[:-1] + g.shape[-1:]),
                   arms], dim=-1)
    vals = self.expected_reward_fn(x)
    if NUM_ACTIONS_FEATURE_KEY in observation:
      k = torch.arange(arms.shape[-2], device=arms.device)
      valid = k < observation[NUM_ACTIONS_FEATURE_KEY][..., None]
      vals = torch.where(valid, vals, -torch.inf)
    return vals

  def optimal_reward_fn(self, observation):
    if self.expected_reward_fn is None:
      raise NotImplementedError
    return torch.max(self._expected_all_arms(observation), dim=-1).values

  def optimal_action_fn(self, observation):
    if self.expected_reward_fn is None:
      raise NotImplementedError
    return torch.argmax(self._expected_all_arms(observation), dim=-1)


class BernoulliActionMaskBandit(BanditTorchEnvironment):
  """Adds a per-round Bernoulli feasibility mask to any bandit env:
  observation = join_fn(context, mask) (a (context, mask) tuple by
  default), mask[k] ~ Bernoulli(action_probability); rounds whose mask is
  all zero get one uniformly random action enabled."""

  def __init__(self, env: BanditTorchEnvironment,
               action_probability: float = 0.5,
               join_fn: Optional[Callable] = None):
    self.env = env
    self.action_probability = action_probability
    self.join_fn = join_fn or (lambda context, mask: (context, mask))
    aspec = env.action_spec()
    self.num_actions = int(aspec.maximum) - int(aspec.minimum) + 1

  def observation_spec(self):
    mask_spec = array_spec.BoundedArraySpec((self.num_actions,), np.int32,
                                            0, 1, "mask")
    return self.join_fn(self.env.observation_spec(), mask_spec)

  def action_spec(self):
    return self.env.action_spec()

  def _sample_context(self, draws, round_):
    batch = round_.shape[0]
    context = self.env._sample_context(draws, round_)
    mask = draws.uniform("action_mask",
                         (batch, self.num_actions)) < self.action_probability
    extra = F.one_hot(
        draws.randint("action_mask_fix", (batch,), 0, self.num_actions),
        self.num_actions).bool()
    mask = torch.where(mask.any(dim=-1, keepdim=True), mask, extra)
    return self.join_fn(context, mask.to(torch.int32))

  def _reward(self, context, action, draws, round_):
    # The inner context is the join's first element (the default tuple's).
    inner = context[0] if isinstance(context, tuple) else context
    return self.env._reward(inner, action, draws, round_)

  def optimal_reward_fn(self, observation):
    """Best expected reward over the FEASIBLE arms."""
    if (isinstance(observation, tuple)
        and hasattr(self.env, "expected_rewards")):
      inner, mask = observation[0], observation[1]
      er = self.env.expected_rewards(inner)
      return torch.max(torch.where(mask.bool(), er, -torch.inf),
                       dim=-1).values
    inner = (observation[0]
             if isinstance(observation, tuple) else observation)
    return self.env.optimal_reward_fn(inner)  # upper bound (no mask info)

  def optimal_action_fn(self, observation):
    if (isinstance(observation, tuple)
        and hasattr(self.env, "expected_rewards")):
      inner, mask = observation[0], observation[1]
      er = self.env.expected_rewards(inner)
      return torch.argmax(torch.where(mask.bool(), er, -torch.inf), dim=-1)
    inner = (observation[0]
             if isinstance(observation, tuple) else observation)
    return self.env.optimal_action_fn(inner)


class FeedbackModel(enum.IntEnum):
  """The shape of the per-round feedback."""
  CASCADING = 1      # dict {chosen_index, chosen_value}
  SCORE_VECTOR = 2   # [num_slots] vector, click value at the chosen slot


class ClickModel(enum.IntEnum):
  """How the modelled user picks an item."""
  GHOST_ACTIONS = 1    # unit-vector ghost items soak up no-clicks
  DISTANCE_BASED = 2   # no click if no score clears a threshold


def _global_and_items(global_sampling_fn, item_sampling_fn, draws, batch,
                      num_items):
  return {
      GLOBAL_FEATURE_KEY: global_sampling_fn(draws, (batch,)),
      PER_ARM_FEATURE_KEY: item_sampling_fn(draws, (batch, num_items)),
  }


class RankingBanditEnv(BanditTorchEnvironment):
  """Slate-ranking environment with per-arm features: each round samples
  a global context and `num_items` item features; the agent returns an
  ordered slate of `num_slots` item indices; a user model scores slotted
  items with itemᵀ W global and clicks (or not). Feedback is CASCADING
  ({chosen_index, chosen_value}) or a SCORE_VECTOR of length num_slots.
  """

  def __init__(self,
               global_sampling_fn: Callable,
               item_sampling_fn: Callable,
               num_items: int,
               num_slots: int,
               scores_weight_matrix,
               global_dim: int,
               item_dim: int,
               feedback_model: FeedbackModel = FeedbackModel.SCORE_VECTOR,
               click_model: ClickModel = ClickModel.GHOST_ACTIONS,
               distance_threshold: float = 10.0,
               real_cascade: bool = False, device="cuda"):
    self.device = resolve_device(device)
    self.global_sampling_fn = global_sampling_fn
    self.item_sampling_fn = item_sampling_fn
    self.num_items = num_items
    self.num_slots = num_slots
    self.W = torch.as_tensor(np.asarray(scores_weight_matrix, np.float32),
                             device=self.device)  # [item, global]
    self.global_dim = global_dim
    self.item_dim = item_dim
    self.feedback_model = feedback_model
    self.click_model = click_model
    self.distance_threshold = distance_threshold
    self.real_cascade = real_cascade
    self._units = torch.eye(item_dim, device=self.device)

  def observation_spec(self):
    return {
        GLOBAL_FEATURE_KEY:
            array_spec.ArraySpec((self.global_dim,), np.float32, "global"),
        PER_ARM_FEATURE_KEY:
            array_spec.ArraySpec((self.num_items, self.item_dim), np.float32,
                                 "per_arm"),
    }

  def action_spec(self):
    return array_spec.BoundedArraySpec((self.num_slots,), np.int32, 0,
                                       self.num_items - 1, "action")

  def reward_spec(self):
    if self.feedback_model == FeedbackModel.CASCADING:
      return {
          "chosen_index": array_spec.ArraySpec((), np.float32,
                                                "chosen_index"),
          "chosen_value": array_spec.ArraySpec((), np.float32,
                                               "chosen_value"),
      }
    return array_spec.ArraySpec((self.num_slots,), np.float32, "reward")

  def _sample_context(self, draws, round_):
    return _global_and_items(self.global_sampling_fn, self.item_sampling_fn,
                             draws, round_.shape[0], self.num_items)

  def _scores(self, global_obs, items):
    # itemᵀ W global for each item: [B, n, i] -> [B, n].
    return torch.einsum("bni,bi->bn", items @ self.W, global_obs)

  def _choose_ghost_actions(self, global_obs, slotted, draws):
    """Slotted items compete with unit-vector ghosts; a ghost pick is a
    no-click."""
    batch = slotted.shape[0]
    with_units = torch.cat(
        [slotted, self._units.expand(batch, -1, -1)], dim=1)
    scores = self._scores(global_obs, with_units)
    perturbed = scores + draws.normal("ranking_perturb", scores.shape)
    probs = torch.sigmoid(perturbed)
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    choice = dist_lib.Categorical(torch.log(probs)).sample(
        draws, site="ranking_choice")
    return torch.clamp(choice, max=self.num_slots)

  def _choose_distance_based(self, global_obs, slotted):
    scores = self._scores(global_obs, slotted)        # [B, num_slots]
    batch = scores.shape[0]
    if self.real_cascade:
      # First slot clearing the threshold; num_slots if none does.
      hits = torch.cat([scores >= self.distance_threshold,
                        torch.ones((batch, 1), dtype=torch.bool,
                                   device=scores.device)], dim=1)
      return torch.argmax(hits.to(torch.int32), dim=-1)
    padded = torch.cat([scores, torch.full((batch, 1),
                                           self.distance_threshold,
                                           device=scores.device)], dim=1)
    return torch.argmax(padded, dim=-1)

  def _reward(self, context, action, draws, round_):
    global_obs = context[GLOBAL_FEATURE_KEY]
    slotted = _take_arms(context[PER_ARM_FEATURE_KEY], action)  # [B, S, i]
    if self.click_model == ClickModel.GHOST_ACTIONS:
      chosen = self._choose_ghost_actions(global_obs, slotted, draws)
    else:
      chosen = self._choose_distance_based(global_obs, slotted)
    clicked = (chosen < self.num_slots).to(torch.float32)
    if self.feedback_model == FeedbackModel.CASCADING:
      return {"chosen_index": chosen.to(torch.float32),
              "chosen_value": clicked}
    # Score vector: the click value in the chosen slot; the no-click column
    # is dropped.
    vec = F.one_hot(chosen.long(), self.num_slots + 1) * clicked[:, None]
    return vec[:, :-1]


def cascading_to_score_vector(chosen_index, chosen_value, num_slots: int):
  """CASCADING feedback as a [.., num_slots] score vector."""
  idx = chosen_index.long()
  vec = F.one_hot(idx, num_slots + 1) * chosen_value[..., None]
  return vec[..., :-1]


class ExplicitPositionalBiasRankingEnv(BanditTorchEnvironment):
  """Ranking env with an explicit per-slot observation probability: a
  slotted item is clicked iff it is observed (Bernoulli(observation_probs
  [slot])) AND relevant (Bernoulli(relevance_fn(global, item)), clipped to
  [0, 1]); one uniform per slot draws the product of both. Feedback is a
  [num_slots] score vector."""

  def __init__(self, global_sampling_fn: Callable,
               item_sampling_fn: Callable, relevance_fn: Callable,
               num_items: int, observation_probs,
               global_dim: int, item_dim: int, device="cuda"):
    self.device = resolve_device(device)
    self.global_sampling_fn = global_sampling_fn
    self.item_sampling_fn = item_sampling_fn
    self.relevance_fn = relevance_fn
    self.num_items = num_items
    probs = np.asarray(observation_probs, np.float32)
    if np.any(probs < 0.0) or np.any(probs > 1.0):
      raise ValueError("Observation probabilities need to be in [0, 1].")
    self.observation_probs = torch.as_tensor(probs, device=self.device)
    self.num_slots = len(probs)
    self.global_dim = global_dim
    self.item_dim = item_dim

  def observation_spec(self):
    return {
        GLOBAL_FEATURE_KEY:
            array_spec.ArraySpec((self.global_dim,), np.float32, "global"),
        PER_ARM_FEATURE_KEY:
            array_spec.ArraySpec((self.num_items, self.item_dim), np.float32,
                                 "per_arm"),
    }

  def action_spec(self):
    return array_spec.BoundedArraySpec((self.num_slots,), np.int32, 0,
                                       self.num_items - 1, "action")

  def reward_spec(self):
    return array_spec.ArraySpec((self.num_slots,), np.float32,
                                "score_vector")

  def _sample_context(self, draws, round_):
    return _global_and_items(self.global_sampling_fn, self.item_sampling_fn,
                             draws, round_.shape[0], self.num_items)

  def _reward(self, context, action, draws, round_):
    global_obs = context[GLOBAL_FEATURE_KEY]
    slotted = _take_arms(context[PER_ARM_FEATURE_KEY], action)
    relevances = torch.clamp(self.relevance_fn(global_obs, slotted), 0.0,
                             1.0)
    click_probs = relevances * self.observation_probs
    u = draws.uniform("ranking_click", click_probs.shape)
    return (u < click_probs).to(torch.float32)
