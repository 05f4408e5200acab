"""Parity helpers for the bandit slice of the PyTorch port, and tests of
them.

The JAX package's bandit environments are written for one row and
`vmap`ped by `BatchedJaxEnv`, each row with its own key; the port's are
batched and ask a draw source for each site's whole batch. The helpers
here re-derive every JAX draw from the JAX package's own key splits
(`BatchedJaxEnv.reset/step`, `BanditJaxEnvironment.reset/step`,
`JaxDriver.run`, `OnPolicyTrainLoop.init/iteration`) as the value the
port's site must return, so that `ReplayDraws` replays them into the
port. Where the JAX draw is a rejection loop (the wheel) or a
permutation (per-arm MovieLens), the replayed record is built to make the
port choose what the JAX run chose.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agents_tpu.bandits import environments as jenvs
from agents_tpu_torch.bandits.environments import bandit_envs
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import (_epsilon_greedy_draws, assert_close,
                                     merge_draws, to_np)

TINY = float(jnp.finfo(jnp.float32).tiny)


# -- per-row draws of one context and one reward -----------------------------

def _linear_ctx(env, k):
  return {"bandit_context": jax.random.uniform(
      k, (env.context_dim,), jnp.float32, env.context_low,
      env.context_high)}


def _normal_reward(env, k):
  return {"bandit_reward_noise": jax.random.normal(k)}


def _bernoulli_reward(env, k):
  return {"bandit_bernoulli": jax.random.uniform(k, (), jnp.float32)}


def _none(env, k):
  return {}


def _wheel_ctx(env, k):
  # The port keeps its first candidate inside the disk: the JAX context.
  x = env._sample_context(k, jnp.zeros((), jnp.int32))
  cand = jnp.zeros((bandit_envs.WHEEL_CANDIDATES, 2)).at[0].set(x)
  return {"wheel_context": cand}


def _classification_ctx(env, k):
  return {"classification_index": jax.random.randint(k, (), 0, env.n)}


def _classification_reward(env, k):
  if env.reward_sampler is None:
    return {}
  return {"mushroom_poison": jax.random.uniform(k, (), jnp.float32)}


def _movielens_ctx(env, k):
  return {"movielens_user": jax.random.randint(k, (), 0, env.num_users)}


def _movielens_per_arm_ctx(env, k):
  k_user, k_movies = jax.random.split(k)
  perm = jax.random.permutation(k_movies, env.num_movies)
  ranks = (jnp.arange(env.num_movies, dtype=jnp.float32) + 0.5) \
      / env.num_movies
  return {"movielens_user": jax.random.randint(k_user, (), 0,
                                               env.num_users),
          "movielens_movies": jnp.zeros((env.num_movies,)).at[perm].set(
              ranks)}


def _action_mask_ctx(inner_ctx):
  def read(env, k):
    k_ctx, k_mask, k_fix = jax.random.split(k, 3)
    return {**inner_ctx(env.env, k_ctx),
            "action_mask": jax.random.uniform(k_mask, (env.num_actions,)),
            "action_mask_fix": jax.random.randint(k_fix, (), 0,
                                                  env.num_actions)}
  return read


def _action_mask_reward(inner_reward):
  return lambda env, k: inner_reward(env.env, k)


def ranking_reward_draws(env, k):
  """`RankingBanditEnv._reward`'s draws (ghost-action clicks)."""
  if env.click_model != jenvs.ClickModel.GHOST_ACTIONS:
    return {}
  k_perturb, k_choice = jax.random.split(k)
  n = env.num_slots + env.item_dim
  return {"ranking_perturb": jax.random.normal(k_perturb, (n,)),
          "ranking_choice": jax.random.uniform(k_choice, (n,), jnp.float32,
                                               TINY, 1.0)}


def positional_reward_draws(env, k):
  return {"ranking_click": jax.random.uniform(k, (env.num_slots,))}


# (context draws, reward draws) per JAX environment class.
READERS = {
    jenvs.StationaryStochasticBandit: (_linear_ctx, _normal_reward),
    jenvs.DriftingLinearBandit: (_linear_ctx, _normal_reward),
    jenvs.BernoulliBandit: (_none, _bernoulli_reward),
    jenvs.WheelBandit: (_wheel_ctx, _normal_reward),
    jenvs.ClassificationBandit: (_classification_ctx,
                                 _classification_reward),
    jenvs.RandomBandit: (
        lambda env, k: {"random_bandit_context": jax.random.normal(
            k, (env.context_dim,))}, _normal_reward),
    jenvs.PiecewiseBernoulliBandit: (_none, _bernoulli_reward),
    jenvs.PiecewiseStationaryStochasticBandit: (
        lambda env, k: {"bandit_context_normal": jax.random.normal(
            k, (env.context_dim,))}, _normal_reward),
    jenvs.MovieLensBandit: (_movielens_ctx, _none),
    jenvs.MovieLensPerArmBandit: (_movielens_per_arm_ctx, _none),
}


def readers_of(env, readers=None):
  if readers is not None:
    return readers
  if isinstance(env, jenvs.BernoulliActionMaskBandit):
    ctx, rew = readers_of(env.env)
    return _action_mask_ctx(ctx), _action_mask_reward(rew)
  return READERS[type(env)]


def _batched(values):
  """{site: [B, ...]} -> {site: [array]}; the wheel's candidates become
  [R, B, 2]."""
  out = {}
  for site, v in values.items():
    v = np.asarray(v)
    if site == "wheel_context":
      v = np.swapaxes(v, 0, 1)
    out[site] = [v]
  return out


def jax_reset_draws(env, key, batch_size, readers=None):
  """`BatchedJaxEnv(env).reset(key)`'s draws in the port's sites."""
  ctx, _ = readers_of(env, readers)
  keys = jax.random.split(key, batch_size)
  return _batched(jax.vmap(
      lambda k: ctx(env, jax.random.split(k)[0]))(keys))


def jax_step_draws(env, k_env, batch_size, readers=None):
  """`BatchedJaxEnv(env).step(..., k_env)`'s draws: every row's reward
  and next context (the bandits' auto-reset draws nothing)."""
  ctx, rew = readers_of(env, readers)
  step_keys = jax.vmap(lambda k: jax.random.split(k)[0])(
      jax.random.split(k_env, batch_size))

  def row(k):
    k_rew, k_ctx = jax.random.split(k)
    return {**rew(env, k_rew), **ctx(env, k_ctx)}

  return _batched(jax.vmap(row)(step_keys))


# -- policies' draws from each collect step's k_pol ---------------------------

def linucb_draws(k_pol, batch_size, iteration):
  return {}


def lints_draws(num_actions, context_dim):
  def draws(k_pol, batch_size, iteration):
    k_ts, _ = jax.random.split(k_pol)
    return {"lints_eps": [np.asarray(jax.random.normal(
        k_ts, (num_actions, context_dim)))]}
  return draws


def epsilon_greedy_draws(action_spec):
  def draws(k_pol, batch_size, iteration):
    return {site: [np.asarray(v)] for site, v in _epsilon_greedy_draws(
        k_pol, batch_size, action_spec).items()}
  return draws


def categorical_draws(num_actions, site="categorical"):
  """The default `Policy._action`'s one categorical leaf: the key split
  once, the Gumbel uniforms [B, K] in [tiny, 1)."""
  def draws(k_pol, batch_size, iteration):
    (k,) = jax.random.split(k_pol, 1)
    return {site: [np.asarray(jax.random.uniform(
        k, (batch_size, num_actions), jnp.float32, TINY, 1.0))]}
  return draws


def neural_linucb_draws(num_actions, encoding_phase_steps):
  """NeuralLinUCB's epsilon-greedy draws, made by the port only while the
  encoder trains (the JAX policy draws them always and discards them)."""
  def draws(k_pol, batch_size, iteration):
    if iteration >= encoding_phase_steps:
      return {}
    k_eps, k_rand = jax.random.split(k_pol)
    return {"random_action": [np.asarray(jax.random.randint(
        k_rand, (batch_size,), 0, num_actions))],
            "explore": [np.asarray(jax.random.uniform(k_eps,
                                                      (batch_size,)))]}
  return draws


def jax_loop_draws(env, key, batch_size, num_iterations, policy_draws,
                   rollout_length=2, readers=None):
  """Every draw of the JAX `OnPolicyTrainLoop.init(key)` and
  `num_iterations` iterations over `BatchedJaxEnv(env, batch_size)` in the
  port's sites: the collect loop's reset, then per step the policy's
  (`policy_draws(k_pol, B, iteration)`) and the env's. Returns (records,
  the agent's init key)."""
  k_agent, k_driver, k_loop = jax.random.split(key, 3)
  records = jax_reset_draws(env, k_driver, batch_size, readers)
  k = k_loop
  for it in range(num_iterations):
    k, k_collect, _ = jax.random.split(k, 3)
    for step_key in jax.random.split(k_collect, rollout_length):
      k_pol, k_env = jax.random.split(step_key)
      records = merge_draws(
          records, policy_draws(k_pol, batch_size, it),
          jax_step_draws(env, k_env, batch_size, readers))
  return records, k_agent


def replay(records, device="cpu"):
  return ReplayDraws(records, device=device)


def assert_tree_close(actual, expected, rtol=1e-5, atol=1e-6, err_msg=""):
  """Leaf-by-leaf comparison of two nests of the same structure (dicts
  compared by key)."""
  if isinstance(expected, dict):
    assert set(actual) == set(expected), err_msg
    for k in expected:
      assert_tree_close(actual[k], expected[k], rtol, atol,
                        f"{err_msg}[{k}]")
  elif isinstance(expected, (tuple, list)):
    assert len(actual) == len(expected), err_msg
    for i, (a, e) in enumerate(zip(actual, expected)):
      assert_tree_close(a, e, rtol, atol, f"{err_msg}[{i}]")
  else:
    assert_close(actual, expected, rtol, atol, err_msg)


def greedy_actions_agree(actions, expected, scores, rel=1e-5):
  """Actions equal wherever the top two scores of a row are more than
  rel * max|score| apart (the rule PERF.md §2 uses for near-ties)."""
  scores = to_np(scores)
  top2 = np.sort(scores, axis=-1)[..., -2:]
  gap = top2[..., 1] - top2[..., 0]
  clear = gap > rel * np.max(np.abs(scores))
  np.testing.assert_array_equal(to_np(actions)[clear],
                                to_np(expected)[clear])
  return clear


# -- tests of the helpers -----------------------------------------------------

def test_reset_draws_rebuild_the_jax_contexts():
  """The replayed context of every row is the JAX row's context."""
  from agents_tpu.environments.jax_environment import BatchedJaxEnv
  theta = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
  jenv = jenvs.StationaryStochasticBandit(theta)
  key = jax.random.key(3)
  _, jts = BatchedJaxEnv(jenv, batch_size=5).reset(key)
  records = jax_reset_draws(jenv, key, 5)
  np.testing.assert_array_equal(records["bandit_context"][0],
                                np.asarray(jts.observation))


def test_greedy_actions_agree_skips_near_ties():
  scores = np.array([[1.0, 1.0 + 1e-7, 0.0], [0.0, 2.0, 1.0]], np.float32)
  clear = greedy_actions_agree(np.array([0, 1]), np.array([1, 1]), scores)
  np.testing.assert_array_equal(clear, [False, True])
  with pytest.raises(AssertionError):
    greedy_actions_agree(np.array([0, 2]), np.array([1, 1]), scores)


def test_loop_draws_count_one_record_per_step_and_site():
  theta = np.eye(3, dtype=np.float32)
  jenv = jenvs.StationaryStochasticBandit(theta)
  records, _ = jax_loop_draws(jenv, jax.random.key(0), 4, 3,
                              lints_draws(3, 3))
  # one reset, then 2 steps per iteration
  assert len(records["bandit_context"]) == 1 + 2 * 3
  assert len(records["bandit_reward_noise"]) == 2 * 3
  assert len(records["lints_eps"]) == 2 * 3
  assert records["lints_eps"][0].shape == (3, 3)
