"""The bandit environments of the PyTorch port against the JAX package's
on the CPU: every environment's reset, step and auto-reset over several
rounds from the same draws (re-derived from the JAX keys and replayed,
`test_torch_bandit_parity_utils`), the round counter advancing across
auto-resets, and the twins of ``tests/test_bandit_envs_extra.py``'s and
``tests/test_bandit_constraints_movielens.py``'s environment checks.

Observations, rewards and discounts compare at float32 rtol 1e-5 / atol
1e-6, step types and round counters exactly, and every replayed draw must
be consumed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu.bandits import environments as jenvs
from agents_tpu.bandits.environments import \
    environment_utilities as jenv_utils
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu.specs import array_spec as jspec
from agents_tpu_torch.bandits import environments as tenvs
from agents_tpu_torch.bandits.environments import \
    environment_utilities as tenv_utils
from agents_tpu_torch.bandits.environments import bandit_envs
from agents_tpu_torch.bandits.specs.bandit_spec_utils import (
    GLOBAL_FEATURE_KEY, NUM_ACTIONS_FEATURE_KEY, PER_ARM_FEATURE_KEY)
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.specs import array_spec as tspec
from test_torch_bandit_parity_utils import (
    assert_tree_close, jax_reset_draws, jax_step_draws, merge_draws,
    positional_reward_draws, ranking_reward_draws, replay)
from test_torch_parity_utils import assert_close, assert_equal, to_np

torch.set_num_threads(1)

B, ROUNDS = 5, 4
THETA = np.random.default_rng(7).normal(size=(4, 3)).astype(np.float32)


def _np_tree(x):
  if isinstance(x, dict):
    return {k: _np_tree(v) for k, v in x.items()}
  if isinstance(x, (tuple, list)):
    return tuple(_np_tree(v) for v in x)
  return to_np(x)


def _actions(aspec, rng, steps):
  """Random actions per step: [B] arms, or [B, S] slates of distinct
  items."""
  out = []
  for _ in range(steps):
    if aspec.shape == ():
      out.append(rng.integers(int(aspec.minimum), int(aspec.maximum) + 1,
                              size=(B,)).astype(np.int32))
    else:
      n = int(aspec.maximum) + 1
      out.append(np.argsort(rng.random((B, n)), axis=1)[
          :, :aspec.shape[0]].astype(np.int32))
  return out


def roll_both(jenv, tenv, readers=None, rounds=ROUNDS, seed=0):
  """Both packages' batched envs from the same draws over 2 * rounds
  steps (each round's step, then its auto-reset); compares every time
  step and round counter and checks every draw was used. Returns the
  port's time steps."""
  key = jax.random.key(seed)
  k_reset, key = jax.random.split(key)
  jb = BatchedJaxEnv(jenv, batch_size=B)
  tb = BatchedTorchEnv(tenv, B, device="cpu")
  records = jax_reset_draws(jenv, k_reset, B, readers)
  jstate, jts = jb.reset(k_reset)
  jsteps = [(jts, jstate.round)]
  actions = _actions(jb.action_spec(), np.random.default_rng(seed),
                     2 * rounds)
  for a in actions:
    key, k_env = jax.random.split(key)
    records = merge_draws(records, jax_step_draws(jenv, k_env, B, readers))
    jstate, jts = jb.step(jstate, jts, jnp.asarray(a), k_env)
    jsteps.append((jts, jstate.round))
  draws = replay(records)
  tstate, t_ts = tb.reset(draws)
  tsteps = [(t_ts, tstate.round)]
  for a in actions:
    tstate, t_ts = tb.step(tstate, t_ts, torch.as_tensor(a), draws)
    tsteps.append((t_ts, tstate.round))
  for i, ((j, jr), (t, tr)) in enumerate(zip(jsteps, tsteps)):
    msg = f"step {i}"
    assert_equal(t.step_type, j.step_type, msg)
    assert_equal(tr, jr, msg)
    assert_tree_close(_np_tree(t.observation), _np_tree(j.observation),
                      err_msg=msg)
    assert_tree_close(_np_tree(t.reward), _np_tree(j.reward), err_msg=msg)
    assert_close(t.discount, j.discount, err_msg=msg)
  assert all(n == 0 for n in draws.remaining().values()), draws.remaining()
  return [t for t, _ in tsteps]


def _pair(name, *args, **kwargs):
  return (getattr(jenvs, name)(*args, **kwargs),
          getattr(tenvs, name)(*args, device="cpu", **kwargs))


@pytest.mark.parametrize("name,args,kwargs", [
    ("StationaryStochasticBandit", (THETA,), dict(noise_std=0.3)),
    ("DriftingLinearBandit", (THETA,), dict(drift_rate=0.3, noise_std=0.1)),
    ("BernoulliBandit", ([0.2, 0.9, 0.5],), {}),
    ("WheelBandit", (), dict(delta=0.3, noise_std=0.5)),
    ("RandomBandit", (), dict(context_dim=3, num_arms=4)),
    ("PiecewiseBernoulliBandit",
     ([[0.1, 0.9], [0.8, 0.2], [0.5, 0.5]], [1, 2]), dict(horizon=16)),
])
def test_env_matches_jax_over_rounds(name, args, kwargs):
  roll_both(*_pair(name, *args, **kwargs))


def test_classification_env_matches_jax_with_table_and_sampler():
  rng = np.random.default_rng(1)
  features = rng.normal(size=(7, 3)).astype(np.float32)
  labels = rng.integers(0, 2, size=(7,)).astype(np.int32)
  table = jenvs.dataset_utilities.classification_reward_table(2, 2)
  roll_both(jenvs.ClassificationBandit(features, labels, table),
            tenvs.ClassificationBandit(features, labels, table,
                                       device="cpu"))
  jsampler, expected = jenvs.dataset_utilities.mushroom_reward_sampler()
  tsampler, texpected = tenvs.dataset_utilities.mushroom_reward_sampler()
  np.testing.assert_array_equal(texpected, expected)
  steps = roll_both(
      jenvs.ClassificationBandit(features, labels, expected, jsampler),
      tenvs.ClassificationBandit(features, labels, expected, tsampler,
                                 device="cpu"))
  assert steps[0].observation.shape == (B, 3)


def test_piecewise_stationary_env_matches_jax_on_the_jax_pieces():
  """The port draws its pieces from a torch generator; given the JAX
  pieces, every round matches."""
  kwargs = dict(context_dim=3, num_arms=2, num_pieces=3, durations=[1, 2],
                seed=4, horizon=16)
  jenv = jenvs.PiecewiseStationaryStochasticBandit(**kwargs)
  tenv = tenvs.PiecewiseStationaryStochasticBandit(device="cpu", **kwargs)
  assert tenv.mu.shape == jenv.mu.shape
  assert tenv.theta.shape == jenv.theta.shape
  tenv.mu = torch.as_tensor(np.array(jenv.mu))
  tenv.theta = torch.as_tensor(np.array(jenv.theta))
  roll_both(jenv, tenv)
  obs = torch.ones((2, 3))
  rounds = torch.tensor([0, 2])
  assert_close(tenv.expected_rewards_at(obs, rounds[0]),
               jenv.expected_rewards_at(jnp.ones((2, 3)), 0))
  assert_close(tenv.expected_rewards_at(obs, 2),
               jenv.expected_rewards_at(jnp.ones((2, 3)), 2))


def test_movielens_envs_match_jax():
  ratings = jenvs.synthetic_ratings_matrix(12, 9, rank=3, seed=2)
  np.testing.assert_array_equal(
      tenvs.synthetic_ratings_matrix(12, 9, rank=3, seed=2), ratings)
  roll_both(*_pair("MovieLensBandit", ratings, rank_k=3, num_movies=6))
  steps = roll_both(*_pair("MovieLensPerArmBandit", ratings, rank_k=3,
                           num_actions=4))
  assert steps[0].observation[PER_ARM_FEATURE_KEY].shape == (B, 4, 3)


def test_action_mask_env_matches_jax():
  jinner, tinner = _pair("StationaryStochasticBandit", THETA)
  steps = roll_both(jenvs.BernoulliActionMaskBandit(jinner, 0.3),
                    tenvs.BernoulliActionMaskBandit(tinner, 0.3))
  for t in steps:
    assert bool((t.observation[1].sum(-1) >= 1).all())
  jenv = jenvs.BernoulliActionMaskBandit(jinner, 0.3)
  tenv = tenvs.BernoulliActionMaskBandit(tinner, 0.3)
  obs = (np.random.default_rng(0).normal(size=(B, 3)).astype(np.float32),
         np.array([[1, 0, 0, 1]] * B, np.int32))
  assert_close(tenv.optimal_reward_fn(tuple(map(torch.as_tensor, obs))),
               jenv.optimal_reward_fn(tuple(map(jnp.asarray, obs))))
  assert_equal(tenv.optimal_action_fn(tuple(map(torch.as_tensor, obs))),
               jenv.optimal_action_fn(tuple(map(jnp.asarray, obs))))


# -- environments over user callables -----------------------------------------

G, A, K = 3, 2, 4
PER_ARM_THETA = np.random.default_rng(3).normal(size=(G + A,)).astype(
    np.float32)


def _per_arm_pair(variable_num_actions):
  theta_t = torch.as_tensor(PER_ARM_THETA)
  jkw = dict(
      global_sampling_fn=lambda k: jax.random.uniform(k, (G,), jnp.float32,
                                                      -1, 1),
      arm_sampling_fn=lambda k: jax.random.uniform(k, (A,), jnp.float32,
                                                   -1, 1),
      reward_fn=lambda x, k: x @ PER_ARM_THETA + 0.1 * jax.random.normal(k),
      expected_reward_fn=lambda x: x @ PER_ARM_THETA,
      global_dim=G, arm_dim=A, max_num_actions=K)
  tkw = dict(
      global_sampling_fn=lambda d, s: d.uniform("g", tuple(s) + (G,), -1, 1),
      arm_sampling_fn=lambda d, s: d.uniform("a", tuple(s) + (A,), -1, 1),
      reward_fn=lambda x, d: x @ theta_t + 0.1 * d.normal(
          "bandit_reward_noise", x.shape[:-1]),
      expected_reward_fn=lambda x: x @ theta_t,
      global_dim=G, arm_dim=A, max_num_actions=K)
  if variable_num_actions:
    jkw["num_actions_fn"] = lambda k: jax.random.randint(k, (), 1, K + 1)
    tkw["num_actions_fn"] = lambda d, s: d.randint("n", s, 1, K + 1)

  def ctx(env, k):
    k_g, k_a, k_n = jax.random.split(k, 3)
    out = {"g": jax.random.uniform(k_g, (G,), jnp.float32, -1, 1),
           "a": jax.vmap(lambda kk: jax.random.uniform(
               kk, (A,), jnp.float32, -1, 1))(jax.random.split(k_a, K))}
    if variable_num_actions:
      out["n"] = jax.random.randint(k_n, (), 1, K + 1)
    return out

  readers = (ctx, lambda env, k: {"bandit_reward_noise":
                                  jax.random.normal(k)})
  return (jenvs.StationaryStochasticPerArmBandit(**jkw),
          tenvs.StationaryStochasticPerArmBandit(**tkw), readers)


@pytest.mark.parametrize("variable_num_actions", [False, True])
def test_per_arm_env_matches_jax(variable_num_actions):
  jenv, tenv, readers = _per_arm_pair(variable_num_actions)
  steps = roll_both(jenv, tenv, readers)
  obs = steps[0].observation
  if variable_num_actions:
    # The JAX package walks the dict in sorted-key order; so does the port.
    assert list(obs) == [GLOBAL_FEATURE_KEY, NUM_ACTIONS_FEATURE_KEY,
                         PER_ARM_FEATURE_KEY]
    assert list(tenv.observation_spec()) == list(obs)
  jobs = {k: jnp.asarray(to_np(v)) for k, v in obs.items()}
  assert_close(tenv.optimal_reward_fn(obs), jenv.optimal_reward_fn(jobs))
  assert_equal(tenv.optimal_action_fn(obs), jenv.optimal_action_fn(jobs))


def test_per_arm_env_reward_uses_chosen_arm():
  """(twin of test_bandit_envs_extra) a noise-free reward is the chosen
  arm's expected reward."""
  theta = torch.as_tensor(PER_ARM_THETA)
  env = tenvs.StationaryStochasticPerArmBandit(
      global_sampling_fn=lambda d, s: d.uniform("g", tuple(s) + (G,)),
      arm_sampling_fn=lambda d, s: d.uniform("a", tuple(s) + (A,)),
      reward_fn=lambda x, d: x @ theta, expected_reward_fn=lambda x: x @ theta,
      global_dim=G, arm_dim=A, max_num_actions=K)
  from agents_tpu_torch.utils.draws import Draws
  draws = Draws(0, "cpu")
  tb = BatchedTorchEnv(env, B, device="cpu")
  state, first = tb.reset(draws)
  action = torch.arange(B) % K
  _, last = tb.step(state, first, action, draws)
  expected = env._expected_all_arms(first.observation)
  assert_close(last.reward, expected[torch.arange(B), action])


def _ranking_pair(feedback, click, real_cascade=False):
  w = np.random.default_rng(5).normal(size=(2, 3)).astype(np.float32)
  common = dict(num_items=5, num_slots=3, scores_weight_matrix=w,
                global_dim=3, item_dim=2, feedback_model=feedback,
                click_model=click, distance_threshold=0.5,
                real_cascade=real_cascade)
  jenv = jenvs.RankingBanditEnv(
      global_sampling_fn=lambda k: jax.random.normal(k, (3,)),
      item_sampling_fn=lambda k: jax.random.normal(k, (2,)), **common)
  tenv = tenvs.RankingBanditEnv(
      global_sampling_fn=lambda d, s: d.normal("rg", tuple(s) + (3,)),
      item_sampling_fn=lambda d, s: d.normal("ri", tuple(s) + (2,)),
      device="cpu", **common)

  def ctx(env, k):
    k_g, k_i = jax.random.split(k)
    return {"rg": jax.random.normal(k_g, (3,)),
            "ri": jax.vmap(lambda kk: jax.random.normal(kk, (2,)))(
                jax.random.split(k_i, 5))}

  return jenv, tenv, (ctx, ranking_reward_draws)


@pytest.mark.parametrize("feedback,click,real_cascade", [
    (jenvs.FeedbackModel.SCORE_VECTOR, jenvs.ClickModel.GHOST_ACTIONS, False),
    (jenvs.FeedbackModel.CASCADING, jenvs.ClickModel.GHOST_ACTIONS, False),
    (jenvs.FeedbackModel.SCORE_VECTOR, jenvs.ClickModel.DISTANCE_BASED,
     False),
    (jenvs.FeedbackModel.CASCADING, jenvs.ClickModel.DISTANCE_BASED, True),
])
def test_ranking_env_matches_jax(feedback, click, real_cascade):
  tfeedback = tenvs.FeedbackModel(int(feedback))
  tclick = tenvs.ClickModel(int(click))
  jenv, tenv, readers = _ranking_pair(feedback, click, real_cascade)
  tenv.feedback_model, tenv.click_model = tfeedback, tclick
  steps = roll_both(jenv, tenv, readers, rounds=6)
  last = steps[1]
  if feedback == jenvs.FeedbackModel.CASCADING:
    vec = tenvs.cascading_to_score_vector(
        last.reward["chosen_index"], last.reward["chosen_value"], 3)
    jvec = jenvs.cascading_to_score_vector(
        jnp.asarray(to_np(last.reward["chosen_index"])),
        jnp.asarray(to_np(last.reward["chosen_value"])), 3)
    assert_close(vec, jvec)
  else:
    assert last.reward.shape == (B, 3)
    assert bool((last.reward.sum(-1) <= 1).all())


def test_positional_bias_env_matches_jax():
  w = np.random.default_rng(6).normal(size=(2, 3)).astype(np.float32)
  wt = torch.as_tensor(w)
  probs = [0.9, 0.5, 0.2]
  jenv = jenvs.ExplicitPositionalBiasRankingEnv(
      global_sampling_fn=lambda k: jax.random.normal(k, (3,)),
      item_sampling_fn=lambda k: jax.random.normal(k, (2,)),
      relevance_fn=lambda g, i: jax.nn.sigmoid(i @ w @ g),
      num_items=5, observation_probs=probs, global_dim=3, item_dim=2)
  tenv = tenvs.ExplicitPositionalBiasRankingEnv(
      global_sampling_fn=lambda d, s: d.normal("rg", tuple(s) + (3,)),
      item_sampling_fn=lambda d, s: d.normal("ri", tuple(s) + (2,)),
      relevance_fn=lambda g, items: torch.sigmoid(
          torch.einsum("bsi,bi->bs", items @ wt, g)),
      num_items=5, observation_probs=probs, global_dim=3, item_dim=2,
      device="cpu")

  def ctx(env, k):
    k_g, k_i = jax.random.split(k)
    return {"rg": jax.random.normal(k_g, (3,)),
            "ri": jax.vmap(lambda kk: jax.random.normal(kk, (2,)))(
                jax.random.split(k_i, 5))}

  roll_both(jenv, tenv, (ctx, positional_reward_draws))
  with pytest.raises(ValueError):
    tenvs.ExplicitPositionalBiasRankingEnv(
        global_sampling_fn=None, item_sampling_fn=None, relevance_fn=None,
        num_items=3, observation_probs=[1.5], global_dim=2, item_dim=2,
        device="cpu")


def test_nonstationary_env_matches_jax_and_threads_rounds():
  spec_j = jspec.ArraySpec((2,), np.float32)
  aspec_j = jspec.BoundedArraySpec((), np.int32, 0, 1)
  jenv = jenvs.NonStationaryStochasticBandit(
      spec_j, aspec_j,
      observation_fn=lambda k, r: jax.random.uniform(k, (2,)) + r,
      reward_fn=lambda o, a, k, r: o[a] * r + jax.random.normal(k),
      optimal_reward_fn=lambda o: jnp.max(o, axis=-1))
  tenv = tenvs.NonStationaryStochasticBandit(
      tspec.ArraySpec((2,), np.float32),
      tspec.BoundedArraySpec((), np.int32, 0, 1),
      observation_fn=lambda d, r: d.uniform("o", (r.shape[0], 2))
      + r[:, None],
      reward_fn=lambda o, a, d, r: o[torch.arange(o.shape[0]), a.long()]
      * r + d.normal("bandit_reward_noise", r.shape),
      optimal_reward_fn=lambda o: torch.max(o, dim=-1).values)
  readers = (lambda env, k: {"o": jax.random.uniform(k, (2,))},
             lambda env, k: {"bandit_reward_noise": jax.random.normal(k)})
  steps = roll_both(jenv, tenv, readers, rounds=5)
  # The observation carries the round: it advances across auto-resets.
  firsts = [t.observation for t in steps[::2]]
  assert [int(f.min()) for f in firsts] == [0, 1, 2, 3, 4, 5]
  with pytest.raises(NotImplementedError):
    tenv.optimal_action_fn(firsts[0])


def test_round_advances_across_auto_reset():
  """(twin of test_bandit_envs_extra.py:317) the auto-reset keeps the
  round counter: after 5 batched steps every row has played 2 or 3
  rounds, and a drifting env's reward uses the advanced round."""
  from agents_tpu_torch.utils.draws import Draws
  env = BatchedTorchEnv(tenvs.StationaryStochasticBandit(
      np.eye(2, dtype=np.float32), noise_std=0.0, device="cpu"), 3,
      device="cpu")
  draws = Draws(0, "cpu")
  state, t = env.reset(draws)
  for _ in range(5):
    state, t = env.step(state, t, torch.zeros(3, dtype=torch.int32), draws)
  assert int(state.round.min()) >= 2, state.round


def test_wheel_candidates_leave_a_row_unfilled_rarely():
  """The wheel's fixed-round sampler: a row is unfilled with probability
  (1 - pi/4)**R; an unfilled row lands on the unit circle, every context
  lies in the disk."""
  p = (1 - np.pi / 4) ** bandit_envs.WHEEL_CANDIDATES
  assert p < 1e-10
  env = tenvs.WheelBandit(device="cpu")
  records = {"wheel_context": [np.full((bandit_envs.WHEEL_CANDIDATES, 2, 2),
                                       0.9, np.float32)]}
  records["wheel_context"][0][3, 1] = [0.1, 0.2]
  ctx = env._sample_context(replay(records), torch.zeros(2, dtype=torch.int32))
  assert_close(ctx[1], [0.1, 0.2])
  assert_close(torch.linalg.vector_norm(ctx[0]), 1.0)
  from agents_tpu_torch.utils.draws import Draws
  big = env._sample_context(Draws(0, "cpu"), torch.zeros(4096,
                                                         dtype=torch.int32))
  assert float((big * big).sum(-1).max()) <= 1.0 + 1e-6


def test_optimal_reward_and_action_fns_match_jax():
  obs = np.random.default_rng(2).uniform(-1, 1, size=(6, 3)).astype(
      np.float32)
  for name, args, kw in [("StationaryStochasticBandit", (THETA,), {}),
                         ("DriftingLinearBandit", (THETA,), {})]:
    jenv, tenv = _pair(name, *args, **kw)
    assert_close(tenv.optimal_reward_fn(torch.as_tensor(obs)),
                 jenv.optimal_reward_fn(jnp.asarray(obs)))
    assert_equal(tenv.optimal_action_fn(torch.as_tensor(obs)),
                 jenv.optimal_action_fn(jnp.asarray(obs)))
  wheel = np.random.default_rng(3).uniform(-0.7, 0.7, (8, 2)).astype(
      np.float32)
  jw, tw = _pair("WheelBandit")
  assert_close(tw.optimal_reward_fn(torch.as_tensor(wheel)),
               jw.optimal_reward_fn(jnp.asarray(wheel)))
  assert_equal(tw.optimal_action_fn(torch.as_tensor(wheel)),
               jw.optimal_action_fn(jnp.asarray(wheel)))
  jb, tb = _pair("BernoulliBandit", [0.1, 0.7, 0.3])
  one = np.ones((4, 1), np.float32)
  assert_close(tb.optimal_reward_fn(torch.as_tensor(one)),
               jb.optimal_reward_fn(jnp.asarray(one)))
  assert_equal(tb.optimal_action_fn(torch.as_tensor(one)),
               jb.optimal_action_fn(jnp.asarray(one)))


# -- twins of the JAX package's environment-utility checks --------------------

def test_piece_schedule_matches_jax():
  for args in [([2, 3], 3, 20), ([1], 2, 7), ([0, 2], 2, 9), ([5], 4, 3)]:
    np.testing.assert_array_equal(tenvs.piece_schedule(*args),
                                  jenvs.piece_schedule(*args))
  with pytest.raises(ValueError):
    tenvs.piece_schedule([-1], 2, 5)
  with pytest.raises(ValueError):
    tenvs.PiecewiseBernoulliBandit([[1.5, 0.0]], [1], device="cpu")


def test_environment_utilities_match_jax():
  x = np.random.default_rng(4).normal(size=(5, 3)).astype(np.float32)
  xt, xj = torch.as_tensor(x), jnp.asarray(x)
  for gen in ("sliding_linear_reward_fn_generator",
              "normalized_sliding_linear_reward_fn_generator",
              "structured_linear_reward_fn_generator"):
    jfns = getattr(jenv_utils, gen)(3, 4, 0.5)
    tfns = getattr(tenv_utils, gen)(3, 4, 0.5, device="cpu")
    assert_close(tenv_utils.compute_optimal_reward(xt, tfns),
                 jenv_utils.compute_optimal_reward(xj, jfns))
    assert_equal(tenv_utils.compute_optimal_action(xt, tfns),
                 jenv_utils.compute_optimal_action(xj, jfns))
    # One key for every arm in JAX: one shared noise draw in the port.
    key = jax.random.key(9)
    noise = np.asarray(jax.random.normal(key, (5,)))
    jall = jenv_utils.stack_reward_fns(jfns)(xj, key)
    tall = tenv_utils.stack_reward_fns(tfns)(
        xt, replay({"linear_reward_noise": [noise]}))
    assert_close(tall, jall)
  thetas = np.random.default_rng(5).normal(size=(2, 3)).astype(np.float32)
  jm = jenv_utils.LinearNormalMultipleRewards(thetas, 0.25)
  tm = tenv_utils.LinearNormalMultipleRewards(thetas, 0.25, device="cpu")
  key = jax.random.key(1)
  assert_close(tm(xt, replay({"linear_reward_noise": [
      np.asarray(jax.random.normal(key, (5, 2)))]})), jm(xj, key))
  assert_close(tm(xt), jm(xj))
  aspec_j = jspec.BoundedArraySpec((), np.int32, 2, 6)
  aspec_t = tspec.BoundedArraySpec((), np.int32, 2, 6)
  assert_close(
      tenv_utils.build_laplacian_over_ordinal_integer_actions(aspec_t,
                                                              device="cpu"),
      jenv_utils.build_laplacian_over_ordinal_integer_actions(aspec_j))
  key = jax.random.key(2)
  ints = jenv_utils.context_sampling_fn(3)(key)
  got = tenv_utils.context_sampling_fn(3)(
      replay({"context_sampling": [np.asarray(ints, np.int64)[None]]}), (1,))
  assert_close(got[0], ints)


def test_dataset_utilities_match_jax(tmp_path):
  data = np.array([["a", "x"], ["b", "x"], ["a", "y"]])
  np.testing.assert_array_equal(
      tenvs.dataset_utilities.one_hot_table(data),
      jenvs.dataset_utilities.one_hot_table(data))
  np.testing.assert_array_equal(
      tenvs.dataset_utilities.classification_reward_table(3, 4, 2.0, -1.0),
      jenvs.dataset_utilities.classification_reward_table(3, 4, 2.0, -1.0))
  rows = ["p," + ",".join("abcdefghijklmnopqrstuv"),
          "e," + ",".join("bcdefghijklmnopqrstuvw")]
  path = tmp_path / "mushroom.csv"
  path.write_text("\n".join(rows) + "\n")
  for a, b in zip(tenvs.dataset_utilities.load_mushroom_csv(str(path)),
                  jenvs.dataset_utilities.load_mushroom_csv(str(path))):
    np.testing.assert_array_equal(a, b)
  cov = tmp_path / "covtype.csv"
  cov.write_text("1.0,2.0,3\n4.0,5.0,1\n")
  for a, b in zip(
      tenvs.dataset_utilities.convert_covertype_dataset(str(cov)),
      jenvs.dataset_utilities.convert_covertype_dataset(str(cov))):
    np.testing.assert_array_equal(a, b)
  with pytest.raises(FileNotFoundError):
    tenvs.dataset_utilities.load_mushroom_csv(str(tmp_path / "none.csv"))
  ml = tmp_path / "ml.csv"
  ml.write_text("1,2,4.0,0\n3,1,2.5,0\n")
  np.testing.assert_array_equal(tenvs.load_movielens_data(str(ml)),
                                jenvs.load_movielens_data(str(ml)))


def test_movielens_rank_k_approximation_matches_svd():
  """(twin of test_bandit_constraints_movielens) the expected rewards are
  the rank-k approximation of the kept users' ratings."""
  ratings = tenvs.synthetic_ratings_matrix(30, 12, rank=4, seed=0)
  env = tenvs.MovieLensBandit(ratings, rank_k=12, num_movies=12,
                              device="cpu")
  kept = ratings[np.sum(ratings[:, :12], axis=1) > 0.0][:, :12]
  approx = env.expected_rewards(env._u_hat)
  np.testing.assert_allclose(to_np(approx), kept, atol=1e-3)
  with pytest.raises(ValueError):
    tenvs.MovieLensBandit(device="cpu")


def test_envs_raise_without_a_card_unless_asked_for_the_cpu():
  if torch.cuda.is_available():
    pytest.skip("a card is present")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    tenvs.StationaryStochasticBandit(THETA)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    tenvs.WheelBandit()
  with pytest.raises(RuntimeError, match="device='cpu'"):
    tenvs.MovieLensBandit(np.ones((3, 3)))
