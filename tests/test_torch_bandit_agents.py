"""The bandit agents, policies, networks, metrics, scalarizers and linear
algebra of the PyTorch port against the JAX package on the CPU.

Each agent starts from the JAX agent's own init (flax params carried
across by `agents_tpu_torch.utils.convert`), trains on the same numpy
experience (one Adam step where it has an optimizer, as after a
conversion; the count-based and linear agents two steps) and acts on the
same time steps with the JAX draws replayed at the port's sites
(`test_torch_bandit_parity_utils`). Tolerances: float32 rtol 1e-5 / atol
1e-6, except Cholesky-solved quantities (theta, the UCB and TS scores,
`solve_spd`) at rtol 1e-4 / atol 1e-5, because LAPACK and XLA factor
differently; greedy actions equal wherever the top two scores are more
than 1e-5·max|score| apart; integers exactly.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agents_tpu import networks as jnetworks
from agents_tpu.bandits import agents as jagents
from agents_tpu.bandits import metrics as jmetrics
from agents_tpu.bandits import multi_objective as jmo
from agents_tpu.bandits import policies as jpolicies
from agents_tpu.bandits.networks import global_and_arm_feature_network as jgaf
from agents_tpu.bandits.specs import bandit_spec_utils as jbsu
from agents_tpu.networks.network import Network as JaxNetwork
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch import networks as tnetworks
from agents_tpu_torch.bandits import agents as tagents
from agents_tpu_torch.bandits import metrics as tmetrics
from agents_tpu_torch.bandits import multi_objective as tmo
from agents_tpu_torch.bandits import policies as tpolicies
from agents_tpu_torch.bandits.networks import \
    global_and_arm_feature_network as tgaf
from agents_tpu_torch.bandits.specs import bandit_spec_utils as tbsu
from agents_tpu_torch.networks.encoding_network import make_encoding_network
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import convert
from examples.bandits_train_eval_torch import DropNet
from test_torch_bandit_parity_utils import (TINY, greedy_actions_agree,
                                            replay)
from test_torch_parity_utils import (_epsilon_greedy_draws, assert_close,
                                     assert_equal, to_np)

torch.set_num_threads(1)

B, D, K = 8, 3, 4
SOLVE = dict(rtol=1e-4, atol=1e-5)


def _specs(d=D, k=K):
  jobs = jspec.ArraySpec((d,), np.float32, "observation")
  tobs = tspec.ArraySpec((d,), np.float32, "observation")
  jact = jspec.BoundedArraySpec((), np.int32, 0, k - 1, "action")
  tact = tspec.BoundedArraySpec((), np.int32, 0, k - 1, "action")
  return (jts.time_step_spec(jobs), jact), (tts.time_step_spec(tobs), tact)


def _tree(fn, x):
  if isinstance(x, dict):
    return {k: _tree(fn, v) for k, v in x.items()}
  if isinstance(x, tuple):
    return tuple(_tree(fn, v) for v in x)
  return fn(x)


def _j(x):
  return _tree(jnp.asarray, x)


def _t(x):
  return _tree(lambda v: torch.as_tensor(np.array(v)), x)


def trajectories(obs, action, reward, policy_info=()):
  """The same one-round frames for both packages ([B] leaves)."""
  n = np.asarray(action).shape[0]
  common = dict(step_type=np.zeros((n,), np.int32),
                next_step_type=np.full((n,), 2, np.int32),
                discount=np.ones((n,), np.float32))
  j = jtj.Trajectory(observation=_j(obs), action=jnp.asarray(action),
                     reward=_j(reward), policy_info=_j(policy_info),
                     **{k: jnp.asarray(v) for k, v in common.items()})
  t = ttj.Trajectory(observation=_t(obs), action=torch.as_tensor(action),
                     reward=_t(reward), policy_info=_t(policy_info),
                     **{k: torch.as_tensor(v) for k, v in common.items()})
  return j, t


def restarts(obs):
  n = np.asarray(jax.tree_util.tree_leaves(obs)[0]).shape[0]
  return jts.restart(_j(obs), batch_size=n), tts.TimeStep(
      step_type=torch.zeros((n,), dtype=torch.int32),
      reward=torch.zeros((n,)), discount=torch.ones((n,)),
      observation=_t(obs))


def _batch(seed, n=B, d=D, k=K, reward=None):
  rng = np.random.default_rng(seed)
  obs = rng.normal(size=(n, d)).astype(np.float32)
  action = rng.integers(0, k, size=(n,)).astype(np.int32)
  r = rng.normal(size=(n,)).astype(np.float32) if reward is None else reward
  return obs, action, r


def _adam_fn(lr=1e-2):
  return lambda p: torch.optim.Adam(p, lr=lr)


# -- linear algebra -----------------------------------------------------------

def test_linalg_matches_jax():
  rng = np.random.default_rng(0)
  m = rng.normal(size=(6, 6))
  a = (m @ m.T + 6 * np.eye(6)).astype(np.float32)
  b = rng.normal(size=(6,)).astype(np.float32)
  b2 = rng.normal(size=(6, 2)).astype(np.float32)
  for rhs in (b, b2):
    assert_close(tpolicies.conjugate_gradient(torch.as_tensor(a),
                                              torch.as_tensor(rhs)),
                 jpolicies.conjugate_gradient(jnp.asarray(a),
                                              jnp.asarray(rhs)), **SOLVE)
  x = rng.normal(size=(6,)).astype(np.float32)
  a_inv = np.linalg.inv(a).astype(np.float32)
  for fn in ("simplified_woodbury_update", "update_inverse"):
    assert_close(getattr(tpolicies, fn)(torch.as_tensor(a_inv),
                                        torch.as_tensor(x)),
                 getattr(jpolicies, fn)(jnp.asarray(a_inv), jnp.asarray(x)))
  batch_a = np.stack([a, a + np.eye(6, dtype=np.float32)])
  batch_b = np.stack([b, 2 * b])
  for ridge in (0.0, 0.5):
    assert_close(tpolicies.solve_spd(torch.as_tensor(batch_a),
                                     torch.as_tensor(batch_b), ridge),
                 jpolicies.solve_spd(jnp.asarray(batch_a),
                                     jnp.asarray(batch_b), ridge), **SOLVE)
  # (twin of test_bandits.py) CG solves the system.
  sol = to_np(tpolicies.conjugate_gradient(torch.as_tensor(a),
                                           torch.as_tensor(b)))
  np.testing.assert_allclose(a @ sol, b, atol=1e-3)


# -- linear agents ------------------------------------------------------------

def _linear_pair(cls, **kw):
  (jtss, jact), (ttss, tact) = _specs()
  return (getattr(jagents, cls)(jtss, jact, **kw),
          getattr(tagents, cls)(ttss, tact, device="cpu", **kw))


def _linear_state_close(t, j, **tol):
  assert_close(t.a_mat, j.a_mat, **tol)
  assert_close(t.b_vec, j.b_vec, **tol)
  assert_close(t.num_samples, j.num_samples, **tol)
  assert t.train_step == int(j.train_step)


@pytest.mark.parametrize("cls", ["LinUcbAgent",
                                 "LinearThompsonSamplingAgent"])
@pytest.mark.parametrize("gamma,weighted", [(1.0, False), (0.9, True)])
def test_linear_agent_matches_jax(cls, gamma, weighted):
  jagent, tagent = _linear_pair(cls, alpha=0.7, gamma=gamma,
                                tikhonov_weight=0.5)
  jstate, tstate = jagent.init(jax.random.key(0)), tagent.init()
  _linear_state_close(tstate, jstate)
  for seed in (1, 2):
    obs, action, reward = _batch(seed)
    jtr, ttr = trajectories(obs, action, reward)
    w = np.random.default_rng(seed).uniform(size=(B,)).astype(np.float32) \
        if weighted else None
    jstate, jinfo = jagent.train(jstate, jtr, None if w is None
                                 else jnp.asarray(w))
    tstate, tinfo = tagent.train(tstate, ttr, None if w is None
                                 else torch.as_tensor(w))
    assert_close(tinfo.loss, jinfo.loss)
  _linear_state_close(tstate, jstate)

  obs = np.random.default_rng(3).normal(size=(B, D)).astype(np.float32)
  jstep, tstep = restarts(obs)
  key = jax.random.key(4)
  k_ts, _ = jax.random.split(key)
  eps = np.asarray(jax.random.normal(k_ts, (K, D)))
  jscores = jagent.policy._scores(jstate, jnp.asarray(obs), k_ts)
  tscores = tagent.policy._scores(tstate, torch.as_tensor(obs),
                                  replay({"lints_eps": [eps]}))
  assert_close(tscores, jscores, **SOLVE)
  jaction = jagent.policy.action(jstate, jstep, (), key).action
  taction = tagent.policy.action(tstate, tstep, (),
                                 replay({"lints_eps": [eps]})).action
  assert taction.dtype == torch.int32
  greedy_actions_agree(taction, jaction, jscores)
  if cls == "LinUcbAgent":
    jd = jagent.policy.distribution(jstate, jstep).action
    td = tagent.policy.distribution(tstate, tstep).action
    greedy_actions_agree(td.mode(), jd.mode(), jscores)
  else:
    with pytest.raises(NotImplementedError):
      tagent.policy.distribution(tstate, tstep)


def test_lints_draws_one_eps_per_call_shared_by_rows():
  _, tagent = _linear_pair("LinearThompsonSamplingAgent")
  state = tagent.init()
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws
  draws = RecordingDraws(Draws(0, "cpu"))
  _, tstep = restarts(np.ones((B, D), np.float32))
  tagent.policy.action(state, tstep, (), draws)
  assert [r.shape for r in draws.records["lints_eps"]] == [(K, D)]


# -- reward-network agents ----------------------------------------------------

def _q_nets(d=D, k=K, layers=(8,)):
  (jtss, jact), (ttss, tact) = _specs(d, k)
  jnet = jnetworks.make_q_network(jtss.observation, jact,
                                  fc_layer_params=layers)
  tnet = tnetworks.make_q_network(ttss.observation, tact,
                                  fc_layer_params=layers, device="cpu")
  return jnet, tnet


def _params_close(tmodule, jparams, to_sd=convert.q_params_to_state_dict,
                  **tol):
  expected = to_sd(jax.device_get(jparams))
  got = tmodule.state_dict()
  assert list(got) == list(expected)
  for name in expected:
    assert_close(got[name], expected[name], err_msg=name, **tol)


def _reward_agent_pair(cls, jnet, tnet, to_sd=convert.q_params_to_state_dict,
                       **kw):
  (jtss, jact), (ttss, tact) = _specs()
  jagent = getattr(jagents, cls)(jtss, jact, jnet, optax.adam(1e-2), **kw)
  tagent = getattr(tagents, cls)(ttss, tact, tnet, _adam_fn(), device="cpu",
                                 **kw)
  jstate = jagent.init(jax.random.key(0))
  tstate = tagent.init()
  tstate = convert.load_reward_net_agent_state(
      tstate, convert.reward_net_agent_state_to_torch(
          jax.device_get(jstate), to_sd))
  return jagent, tagent, jstate, tstate


def _train_once(jagent, tagent, jstate, tstate, reward_fn=None):
  for seed in (11,):
    obs, action, reward = _batch(seed)
    if reward_fn is not None:
      reward = reward_fn(obs, action)
    jtr, ttr = trajectories(obs, action, reward)
    jstate, jinfo = jagent.train(jstate, jtr)
    tstate, tinfo = tagent.train(tstate, ttr)
    assert_close(tinfo.loss, jinfo.loss)
  return jstate, tstate


def _epsilon_greedy_records(key):
  """`EpsilonGreedyPolicy`'s random actions and coins (its JAX key
  splits, `test_torch_parity_utils._epsilon_greedy_draws`)."""
  (_, jact), _ = _specs()
  return {site: [np.asarray(v)] for site, v in
          _epsilon_greedy_draws(key, B, jact).items()}


def _categorical_records(key, n=K, site="categorical"):
  (k,) = jax.random.split(key, 1)
  return {site: [np.asarray(jax.random.uniform(k, (B, n), jnp.float32, TINY,
                                               1.0))]}


@pytest.mark.parametrize("cls,kw,records", [
    ("GreedyRewardPredictionAgent", {}, lambda k: {}),
    ("NeuralEpsilonGreedyAgent", dict(epsilon=0.5), _epsilon_greedy_records),
    ("NeuralBoltzmannAgent", dict(temperature=0.5), _categorical_records),
    ("NeuralFalconAgent", dict(exploitation_coefficient=2.0),
     _categorical_records),
])
def test_reward_net_agent_matches_jax(cls, kw, records):
  jagent, tagent, jstate, tstate = _reward_agent_pair(cls, *_q_nets(), **kw)
  _params_close(tstate.params, jstate.params)
  jstate, tstate = _train_once(jagent, tagent, jstate, tstate)
  _params_close(tstate.params, jstate.params)
  assert tstate.train_step == int(jstate.train_step) == 1
  obs = np.random.default_rng(5).normal(size=(B, D)).astype(np.float32)
  jstep, tstep = restarts(obs)
  key = jax.random.key(6)
  jaction = jagent.collect_policy.action(
      jagent.collect_policy_params(jstate), jstep, (), key).action
  taction = tagent.collect_policy.action(
      tagent.collect_policy_params(tstate), tstep, (),
      replay(records(key))).action
  assert_equal(taction, jaction)
  jgreedy = jagent.policy.action(jagent.policy_params(jstate), jstep, (),
                                 key).action
  tgreedy = tagent.policy.action(tagent.policy_params(tstate), tstep).action
  assert_equal(tgreedy, jgreedy)
  if cls == "NeuralFalconAgent":
    jd = jagent.collect_policy.distribution(
        jagent.collect_policy_params(jstate), jstep).action
    td = tagent.collect_policy.distribution(
        tagent.collect_policy_params(tstate), tstep).action
    assert_close(td.probs, jd.probs)


def test_per_arm_greedy_agent_matches_jax():
  """(twin of test_bandits_extra.py's per-arm greedy agent) the global-and-
  arm network under epsilon-greedy, trained and acting as in JAX."""
  jspec_, tspec_ = (jbsu.create_per_arm_observation_spec(3, 2, K),
                    tbsu.create_per_arm_observation_spec(3, 2, K))
  jnet = jgaf.make_global_and_arm_feature_network(jspec_)
  tnet = tgaf.make_global_and_arm_feature_network(tspec_, device="cpu")
  jact = jspec.BoundedArraySpec((), np.int32, 0, K - 1)
  tact = tspec.BoundedArraySpec((), np.int32, 0, K - 1)
  jagent = jagents.NeuralEpsilonGreedyAgent(
      jts.time_step_spec(jspec_), jact, jnet, optax.adam(1e-2), epsilon=0.3)
  tagent = tagents.NeuralEpsilonGreedyAgent(
      tts.time_step_spec(tspec_), tact, tnet, _adam_fn(), epsilon=0.3,
      device="cpu")
  jstate = jagent.init(jax.random.key(0))
  to_sd = lambda p: convert.dense_stack_params_to_state_dict(p, tnet)  # noqa
  tstate = convert.load_reward_net_agent_state(
      tagent.init(), convert.reward_net_agent_state_to_torch(
          jax.device_get(jstate), to_sd))
  rng = np.random.default_rng(2)
  for _ in range(1):
    obs = {"global": rng.normal(size=(B, 3)).astype(np.float32),
           "per_arm": rng.normal(size=(B, K, 2)).astype(np.float32)}
    action = rng.integers(0, K, size=(B,)).astype(np.int32)
    jtr, ttr = trajectories(obs, action,
                            rng.normal(size=(B,)).astype(np.float32))
    jstate, jinfo = jagent.train(jstate, jtr)
    tstate, tinfo = tagent.train(tstate, ttr)
    assert_close(tinfo.loss, jinfo.loss)
  _params_close(tstate.params, jstate.params, to_sd)
  jstep, tstep = restarts(obs)
  key = jax.random.key(3)
  assert_equal(
      tagent.collect_policy.action(tstate.params, tstep, (),
                                   replay(_epsilon_greedy_records(key))
                                   ).action,
      jagent.collect_policy.action(jstate.params, jstep, (), key).action)


# -- constraints --------------------------------------------------------------

def _constraint_pairs():
  """(JAX, port) constraints of every trainable kind, over Q networks."""
  (jtss, jact), (ttss, tact) = _specs()
  out = []
  for kind, kw in [("AbsoluteConstraint", dict(absolute_value=0.1)),
                   ("RelativeConstraint", dict(margin=0.2)),
                   ("QuantileConstraint", dict(quantile=0.3,
                                               quantile_value=-0.1)),
                   ("RelativeQuantileConstraint", dict(quantile=0.7)),
                   ("NeuralConstraint", {})]:
    jnet, tnet = _q_nets()
    out.append((getattr(jpolicies, kind)(jtss, jact, jnet, **kw),
                getattr(tpolicies, kind)(ttss, tact, tnet, **kw)))
  return out


@pytest.mark.parametrize("epsilon", [0.0, 0.4])
def test_constrained_greedy_agent_matches_jax(epsilon):
  pairs = _constraint_pairs()
  jc, tc = zip(*pairs)
  jnet, tnet = _q_nets()
  (jtss, jact), (ttss, tact) = _specs()
  jagent = jagents.NeuralEpsilonGreedyAgent(
      jtss, jact, jnet, optax.adam(1e-2), constraints=jc, epsilon=epsilon)
  tagent = tagents.NeuralEpsilonGreedyAgent(
      ttss, tact, tnet, _adam_fn(), constraints=tc, epsilon=epsilon,
      device="cpu")
  jstate = jagent.init(jax.random.key(0))
  q_sd = convert.q_params_to_state_dict
  to_sd = {"reward": q_sd, "constraints": (q_sd,) * len(jc)}
  tstate = convert.load_reward_net_agent_state(
      tagent.init(), convert.reward_net_agent_state_to_torch(
          jax.device_get(jstate), to_sd))

  def reward(obs, action):
    rng = np.random.default_rng(int(action.sum()))
    return {"reward": rng.normal(size=(B,)).astype(np.float32),
            "constraint": rng.normal(size=(B, len(jc))).astype(np.float32)}

  jstate, tstate = _train_once(jagent, tagent, jstate, tstate, reward)
  _params_close(tstate.params["reward"], jstate.params["reward"])
  for tp, jp in zip(tstate.params["constraints"],
                    jstate.params["constraints"]):
    _params_close(tp, jp)
  obs = np.random.default_rng(8).normal(size=(B, D)).astype(np.float32)
  jstep, tstep = restarts(obs)
  for policy in ("policy", "collect_policy"):
    key = jax.random.key(9)
    k_mask, k_eps, k_rand = jax.random.split(key, 3)
    records = {"constraint_mask": [np.asarray(jax.random.uniform(
        k_mask, (B, K)))]}
    if policy == "collect_policy" and epsilon:
      records.update(random_action=[np.asarray(jax.random.randint(
          k_rand, (B,), 0, K))], explore=[np.asarray(jax.random.uniform(
              k_eps, (B,)))])
    jpol, tpol = getattr(jagent, policy), getattr(tagent, policy)
    assert_equal(tpol.action(tstate.params, tstep, (), replay(records)).action,
                 jpol.action(jstate.params, jstep, (), key).action)
    assert_equal(tpol.distribution(tstate.params, tstep).action.mode(),
                 jpol.distribution(jstate.params, jstep).action.mode())


def test_constraint_functions_match_jax():
  y, p = np.array([1.0, 3.0, -2.0], np.float32), np.array(
      [3.0, 1.0, -2.5], np.float32)
  assert_close(tpolicies.pinball_loss(torch.as_tensor(y),
                                      torch.as_tensor(p), 0.25),
               jpolicies.pinball_loss(jnp.asarray(y), jnp.asarray(p), 0.25))
  # (twins of test_bandit_constraints_movielens)
  obs = {"f": np.ones((3, 2), np.float32),
         "num_actions": np.array([1, 3, 2], np.int32)}
  _, mask = tpolicies.construct_mask_from_multiple_sources(
      None, _t(obs), None, (), (), 4)
  _, jmask = jpolicies.construct_mask_from_multiple_sources(
      jax.random.key(0), _j(obs), None, (), (), 4)
  assert_equal(mask, jmask)
  (jtss, jact), (ttss, tact) = _specs()
  nets = [_q_nets() for _ in range(2)]
  jc = [jpolicies.AbsoluteConstraint(jtss, jact, n[0], absolute_value=v)
        for n, v in zip(nets, (-1e9, 1e9))]
  tc = [tpolicies.AbsoluteConstraint(ttss, tact, n[1], absolute_value=v)
        for n, v in zip(nets, (-1e9, 1e9))]
  jp = [c.init_params(jax.random.key(i)) for i, c in enumerate(jc)]
  tp = [c.init_params() for c in tc]
  o = np.ones((4, D), np.float32)
  for sl in (slice(0, 2), slice(0, 1)):
    assert_close(tpolicies.compute_feasibility_probability(
        torch.as_tensor(o), tc[sl], tp[sl], K),
                 jpolicies.compute_feasibility_probability(
                     jnp.asarray(o), jc[sl], jp[sl], K))
  base_j = jpolicies.NeuralConstraint(jtss, jact, nets[0][0])
  base_t = tpolicies.NeuralConstraint(ttss, tact, nets[0][1])
  assert_close(base_t(base_t.init_params(), torch.as_tensor(o)),
               base_j(base_j.init_params(jax.random.key(0)), jnp.asarray(o)))
  inp = tpolicies.InputNetworkConstraint(ttss, tact)
  assert float(inp.compute_loss((), torch.as_tensor(o), None, None)) == 0.0


# -- count-based agents -------------------------------------------------------

def test_bernoulli_ts_matches_jax():
  (jtss, jact), (ttss, tact) = _specs(1, K)
  jagent = jagents.BernoulliThompsonSamplingAgent(jtss, jact)
  tagent = tagents.BernoulliThompsonSamplingAgent(ttss, tact, device="cpu")
  jstate, tstate = jagent.init(jax.random.key(0)), tagent.init()
  rng = np.random.default_rng(0)
  for _ in range(2):
    action = rng.integers(0, K, size=(B,)).astype(np.int32)
    reward = rng.integers(0, 2, size=(B,)).astype(np.float32)
    jtr, ttr = trajectories(np.ones((B, 1), np.float32), action, reward)
    jstate, jinfo = jagent.train(jstate, jtr)
    tstate, tinfo = tagent.train(tstate, ttr)
    assert_close(tinfo.loss, jinfo.loss)
  assert_close(tstate.alpha, jstate.alpha)
  assert_close(tstate.beta, jstate.beta)
  jstep, tstep = restarts(np.ones((B, 1), np.float32))
  key = jax.random.key(1)
  # JAX's beta goes through log-gamma; the variates themselves replay.
  theta = np.asarray(jax.random.beta(key, jstate.alpha[None],
                                     jstate.beta[None], (B, K)))
  assert_equal(tagent.policy.action(tstate, tstep, (), replay(
      {"bernoulli_ts_theta": [theta]})).action,
               jagent.policy.action(jstate, jstep, (), key).action)


def test_exp3_matches_jax():
  (jtss, jact), (ttss, tact) = _specs(1, K)
  jagent = jagents.Exp3Agent(jtss, jact, learning_rate=0.3)
  tagent = tagents.Exp3Agent(ttss, tact, learning_rate=0.3, device="cpu")
  jstate, tstate = jagent.init(jax.random.key(0)), tagent.init()
  rng = np.random.default_rng(1)
  for _ in range(2):
    action = rng.integers(0, K, size=(B,)).astype(np.int32)
    reward = rng.uniform(size=(B,)).astype(np.float32)
    jtr, ttr = trajectories(np.ones((B, 1), np.float32), action, reward)
    jstate, _ = jagent.train(jstate, jtr)
    tstate, _ = tagent.train(tstate, ttr)
  assert_close(tstate.log_weights, jstate.log_weights)
  jstep, tstep = restarts(np.ones((B, 1), np.float32))
  key = jax.random.key(2)
  assert_equal(tagent.policy.action(tstate, tstep, (),
                                    replay(_categorical_records(key))).action,
               jagent.policy.action(jstate, jstep, (), key).action)


# -- NeuralLinUCB -------------------------------------------------------------

def test_neural_linucb_matches_jax_in_both_phases():
  (jtss, jact), (ttss, tact) = _specs()
  jenc = jnetworks.make_encoding_network(jtss.observation,
                                         fc_layer_params=(6,))
  tenc = make_encoding_network(ttss.observation, fc_layer_params=(6,),
                               device="cpu")
  kw = dict(encoding_dim=6, alpha=0.8, gamma=0.95, epsilon_greedy=0.5,
            encoding_phase_steps=2)
  jagent = jagents.NeuralLinUcbAgent(jtss, jact, jenc,
                                     optimizer=optax.adam(1e-2), **kw)
  tagent = tagents.NeuralLinUcbAgent(ttss, tact, tenc,
                                     optimizer_fn=_adam_fn(), device="cpu",
                                     **kw)
  jstate = jagent.init(jax.random.key(0))
  tstate = tagent.init()
  tstate.encoder_params.load_state_dict(
      convert.neural_linucb_params_to_state_dict(
          jax.device_get(jstate.encoder_params)))
  obs = np.random.default_rng(9).normal(size=(B, D)).astype(np.float32)
  jstep, tstep = restarts(obs)
  for step in range(4):
    key = jax.random.key(20 + step)
    k_eps, k_rand = jax.random.split(key)
    records = {} if step >= 2 else {
        "random_action": [np.asarray(jax.random.randint(k_rand, (B,), 0,
                                                        K))],
        "explore": [np.asarray(jax.random.uniform(k_eps, (B,)))]}
    draws = replay(records)
    taction = tagent.policy.action(tstate, tstep, (), draws).action
    jaction = jagent.policy.action(jstate, jstep, (), key).action
    assert all(n == 0 for n in draws.remaining().values())
    (feats, _), _ = tstate.encoder_params(torch.as_tensor(obs))
    chol = torch.linalg.cholesky(tstate.a_mat)
    theta = torch.cholesky_solve(tstate.b_vec[..., None], chol)[..., 0]
    from agents_tpu_torch.bandits.policies.linear_bandit_policy import \
        ucb_scores
    scores = ucb_scores(chol, theta, feats.detach(), 0.8)
    explore = (np.asarray(records["explore"][0]) < 0.5 if records
               else np.zeros(B, bool))
    clear = greedy_actions_agree(taction[~explore], jaction[~explore],
                                 scores.detach()[~explore])
    assert_equal(taction[explore], jaction[explore])
    b_obs, b_act, b_rew = _batch(30 + step)
    jtr, ttr = trajectories(b_obs, b_act, b_rew)
    jstate, jinfo = jagent.train(jstate, jtr)
    tstate, tinfo = tagent.train(tstate, ttr)
    assert_close(tinfo.loss, jinfo.loss)
    _params_close(tstate.encoder_params, jstate.encoder_params,
                  convert.neural_linucb_params_to_state_dict)
    assert_close(tstate.a_mat, jstate.a_mat)
    assert_close(tstate.b_vec, jstate.b_vec)
  assert tstate.train_step == 4


# -- mixture, dropout TS, multi-objective, ranking ----------------------------

@pytest.mark.parametrize("cls", ["StaticMixtureAgent", "Exp3MixtureAgent",
                                 "MixtureAgent"])
def test_mixture_agent_matches_jax(cls):
  (jtss, jact), (ttss, tact) = _specs(1, K)
  jsubs = [jagents.BernoulliThompsonSamplingAgent(jtss, jact),
           jagents.Exp3Agent(jtss, jact, learning_rate=0.2)]
  tsubs = [tagents.BernoulliThompsonSamplingAgent(ttss, tact, device="cpu"),
           tagents.Exp3Agent(ttss, tact, learning_rate=0.2, device="cpu")]
  kw = {} if cls == "StaticMixtureAgent" else dict(learning_rate=0.5)
  if cls == "MixtureAgent":
    kw["mixture_weights"] = [1.0, 3.0]
  jagent = getattr(jagents, cls)(jtss, jact, jsubs, **kw)
  tagent = getattr(tagents, cls)(ttss, tact, tsubs, device="cpu", **kw)
  jstate, tstate = jagent.init(jax.random.key(0)), tagent.init()
  jstep, tstep = restarts(np.ones((B, 1), np.float32))
  for step in range(2):
    key = jax.random.key(40 + step)
    k_choice, k_bts, k_exp3 = jax.random.split(key, 3)
    jparams = jagent.policy_params(jstate)
    bts = jparams[1][0]
    records = {
        "mixture_choice": [np.asarray(jax.random.uniform(
            k_choice, (B, 2), jnp.float32, TINY, 1.0))],
        "bernoulli_ts_theta": [np.asarray(jax.random.beta(
            k_bts, bts.alpha[None], bts.beta[None], (B, K)))],
        **_categorical_records(k_exp3)}
    jout = jagent.collect_policy.action(jparams, jstep, (), key)
    tout = tagent.collect_policy.action(tagent.policy_params(tstate), tstep,
                                        (), replay(records))
    assert_equal(tout.action, jout.action)
    assert_equal(tout.info["mixture_choice"], jout.info["mixture_choice"])
    assert_close(tout.info["mixture_prob"], jout.info["mixture_prob"])
    reward = np.random.default_rng(step).integers(0, 2, (B,)).astype(
        np.float32)
    jtr, ttr = trajectories(np.ones((B, 1), np.float32),
                            np.asarray(jout.action), reward,
                            jax.device_get(jout.info))
    jstate, jinfo = jagent.train(jstate, jtr)
    tstate, tinfo = tagent.train(tstate, ttr)
    assert_close(tinfo.loss, jinfo.loss)
  assert_close(tstate.mixture_log_weights, jstate.mixture_log_weights)
  assert_close(tstate.sub_states[0].alpha, jstate.sub_states[0].alpha)
  assert_close(tstate.sub_states[1].log_weights,
               jstate.sub_states[1].log_weights)
  assert tstate.train_step == 2


class _JaxDropNet(fnn.Module):
  @fnn.compact
  def __call__(self, obs, step_type=None, state=(), training=False):
    x = fnn.relu(fnn.Dense(16)(obs.astype(jnp.float32)))
    x = fnn.Dropout(0.3, deterministic=not training)(x)
    return fnn.Dense(3)(x), state


def test_dropout_ts_agent_matches_jax():
  """The JAX dropout mask replays at "dropout_keep" (read from the flax
  Dropout's output: kept units are the nonzero ones)."""
  (jtss, jact), (ttss, tact) = _specs(2, 3)
  jnet = JaxNetwork(_JaxDropNet(), jtss.observation)
  tnet = DropNet(2, 3, rate=0.3, width=16, device="cpu")
  jagent = jagents.DropoutThompsonSamplingAgent(jtss, jact, jnet,
                                                optax.adam(1e-2))
  tagent = tagents.DropoutThompsonSamplingAgent(ttss, tact, tnet, _adam_fn(),
                                                device="cpu")
  jstate = jagent.init(jax.random.key(0))
  to_sd = lambda p: convert.dense_stack_params_to_state_dict(p, tnet)  # noqa
  tstate = convert.load_reward_net_agent_state(
      tagent.init(), convert.reward_net_agent_state_to_torch(
          jax.device_get(jstate), to_sd))
  rng = np.random.default_rng(4)
  for _ in range(1):
    obs = rng.normal(size=(B, 2)).astype(np.float32)
    action = rng.integers(0, 3, size=(B,)).astype(np.int32)
    jtr, ttr = trajectories(obs, action, rng.normal(size=(B,)).astype(
        np.float32))
    jstate, jinfo = jagent.train(jstate, jtr)
    tstate, tinfo = tagent.train(tstate, ttr)
    assert_close(tinfo.loss, jinfo.loss)
  _params_close(tstate.params, jstate.params, to_sd)
  jstep, tstep = restarts(obs)
  key = jax.random.key(5)
  _, inter = jnet.module.apply(
      jstate.params, jnp.asarray(obs), None, (), training=True,
      rngs={"dropout": key}, capture_intermediates=True,
      mutable=["intermediates"])
  dropped = np.asarray(inter["intermediates"]["Dropout_0"]["__call__"][0])
  u = np.where(dropped != 0, 0.0, 0.999).astype(np.float32)
  assert_equal(tagent.collect_policy.action(
      tstate.params, tstep, (), replay({"dropout_keep": [u]})).action,
               jagent.collect_policy.action(jstate.params, jstep, (),
                                            key).action)


def test_multi_objective_agent_matches_jax():
  (jtss, jact), (ttss, tact) = _specs(2, 3)
  nets = [_q_nets(2, 3) for _ in range(2)]
  jagent = jagents.GreedyMultiObjectiveNeuralAgent(
      jtss, jact, [n[0] for n in nets], jmo.LinearScalarizer([1.0, 0.5]),
      optax.adam(1e-2))
  tagent = tagents.GreedyMultiObjectiveNeuralAgent(
      ttss, tact, [n[1] for n in nets], tmo.LinearScalarizer([1.0, 0.5]),
      _adam_fn(), device="cpu")
  jstate = jagent.init(jax.random.key(0))
  tstate = tagent.init()
  for tnet, jp in zip(tstate.params, jstate.params):
    tnet.load_state_dict(convert.q_params_to_state_dict(jax.device_get(jp)))
  rng = np.random.default_rng(6)
  for _ in range(1):
    obs = rng.normal(size=(B, 2)).astype(np.float32)
    action = rng.integers(0, 3, size=(B,)).astype(np.int32)
    jtr, ttr = trajectories(obs, action, rng.normal(size=(B, 2)).astype(
        np.float32))
    jstate, jinfo = jagent.train(jstate, jtr)
    tstate, tinfo = tagent.train(tstate, ttr)
    assert_close(tinfo.loss, jinfo.loss)
  for tnet, jp in zip(tstate.params, jstate.params):
    _params_close(tnet, jp)
  jstep, tstep = restarts(obs)
  assert_equal(tagent.policy.action(tstate.params, tstep).action,
               jagent.policy.action(jstate.params, jstep, (),
                                    jax.random.key(0)).action)


def test_ranking_agent_matches_jax():
  jspec_ = jbsu.create_per_arm_observation_spec(3, 2, K)
  tspec_ = tbsu.create_per_arm_observation_spec(3, 2, K)
  jnet = jgaf.make_global_and_arm_feature_network(jspec_)
  tnet = tgaf.make_global_and_arm_feature_network(tspec_, device="cpu")
  slate = 3
  jagent = jagents.RankingAgent(
      jts.time_step_spec(jspec_),
      jspec.BoundedArraySpec((slate,), np.int32, 0, K - 1), jnet,
      optax.adam(1e-2), slate_size=slate, diversity_penalty=0.5)
  tagent = tagents.RankingAgent(
      tts.time_step_spec(tspec_),
      tspec.BoundedArraySpec((slate,), np.int32, 0, K - 1), tnet,
      _adam_fn(), slate_size=slate, diversity_penalty=0.5, device="cpu")
  jstate = jagent.init(jax.random.key(0))
  to_sd = lambda p: convert.dense_stack_params_to_state_dict(p, tnet)  # noqa
  tstate = convert.load_reward_net_agent_state(
      tagent.init(), convert.reward_net_agent_state_to_torch(
          jax.device_get(jstate), to_sd))
  rng = np.random.default_rng(7)
  for _ in range(2):
    obs = {"global": rng.normal(size=(B, 3)).astype(np.float32),
           "per_arm": rng.normal(size=(B, K, 2)).astype(np.float32)}
    jstep, tstep = restarts(obs)
    jslate = jagent.policy.action(jstate.params, jstep, (),
                                  jax.random.key(0)).action
    tslate = tagent.policy.action(tstate.params, tstep).action
    assert_equal(tslate, jslate)
    assert tslate.shape == (B, slate)
    # distinct items in every slate
    assert all(len(set(r)) == slate for r in to_np(tslate).tolist())
    jtr, ttr = trajectories(obs, np.asarray(jslate),
                            rng.uniform(size=(B, slate)).astype(np.float32))
    jstate, jinfo = jagent.train(jstate, jtr)
    tstate, tinfo = tagent.train(tstate, ttr)
    assert_close(tinfo.loss, jinfo.loss)
  _params_close(tstate.params, jstate.params, to_sd)


# -- networks, metrics, scalarizers -------------------------------------------

def test_per_arm_networks_match_jax():
  spec_j = jbsu.create_per_arm_observation_spec(3, 2, K, True)
  spec_t = tbsu.create_per_arm_observation_spec(3, 2, K, True)
  assert list(spec_t) == sorted(spec_j)
  assert tbsu.get_context_dims_from_spec(spec_t) == \
      jbsu.get_context_dims_from_spec(spec_j)
  rng = np.random.default_rng(0)
  obs = {"global": rng.normal(size=(5, 3)).astype(np.float32),
         "num_actions": np.array([1, 2, 3, 4, 4], np.int32),
         "per_arm": rng.normal(size=(5, K, 2)).astype(np.float32)}
  jnet = jgaf.make_global_and_arm_feature_network(
      spec_j, global_layers=(4, 5), arm_layers=(3,), common_layers=(6, 2))
  tnet = tgaf.make_global_and_arm_feature_network(
      spec_t, global_layers=(4, 5), arm_layers=(3,), common_layers=(6, 2),
      device="cpu")
  params = jnet.init_params(jax.random.key(1))
  tnet.load_state_dict(convert.dense_stack_params_to_state_dict(
      jax.device_get(params), tnet))
  out, _ = tnet(_t(obs))
  assert out.shape == (5, K)
  assert_close(out, jnet.apply(params, _j(obs))[0])
  jhet = jgaf.HeteroscedasticQModule(num_actions=K, fc_layers=(7,))
  thet = tgaf.HeteroscedasticQModule(spec_t, K, fc_layers=(7,), device="cpu")
  hparams = jhet.init(jax.random.key(2), _j(obs))
  thet.load_state_dict(convert.dense_stack_params_to_state_dict(
      jax.device_get(hparams), thet))
  (tm, tv), _ = thet(_t(obs))
  (jm, jv), _ = jhet.apply(hparams, _j(obs))
  assert_close(tm, jm)
  assert_close(tv, jv)


def _metric_trajectory(seed):
  """Frames whose next step is LAST (a round) or MID (a boundary)."""
  rng = np.random.default_rng(seed)
  obs = rng.normal(size=(B, D)).astype(np.float32)
  action = rng.integers(0, K, size=(B,)).astype(np.int32)
  reward = rng.normal(size=(B,)).astype(np.float32)
  nst = np.where(rng.uniform(size=(B,)) < 0.6, 2, 1).astype(np.int32)
  j, t = trajectories(obs, action, reward)
  return (j.replace(next_step_type=jnp.asarray(nst)),
          t.replace(next_step_type=torch.as_tensor(nst)))


def test_metrics_match_jax():
  w = np.random.default_rng(1).normal(size=(K, D)).astype(np.float32)
  wj, wt = jnp.asarray(w), torch.as_tensor(w)
  pairs = [
      (jmetrics.RegretMetric(lambda o: jnp.max(o @ wj.T, -1)),
       tmetrics.RegretMetric(lambda o: torch.max(o @ wt.T, -1).values)),
      (jmetrics.SuboptimalArmsMetric(lambda o: jnp.argmax(o @ wj.T, -1)),
       tmetrics.SuboptimalArmsMetric(lambda o: torch.argmax(o @ wt.T, -1))),
      (jmetrics.ConstraintViolationsMetric(
          lambda o, a: (a == 0).astype(jnp.float32)),
       tmetrics.ConstraintViolationsMetric(
           lambda o, a: (a == 0).to(torch.float32))),
      (jmetrics.DistanceFromGreedyMetric(lambda o: o @ wj.T),
       tmetrics.DistanceFromGreedyMetric(lambda o: o @ wt.T)),
  ]
  for jm, tm in pairs:
    assert tm.name == jm.name
    js, ts_ = jm.init(B), tm.init(B, "cpu")
    assert_close(tm.result(ts_), jm.result(js))
    for seed in (0, 1):
      jtr, ttr = _metric_trajectory(seed)
      js, ts_ = jm.update(js, jtr), tm.update(ts_, ttr)
    assert_close(tm.result(ts_), jm.result(js), err_msg=jm.name)
    assert_close(ts_[1], js[1])


def test_scalarizers_match_jax():
  m = np.random.default_rng(0).normal(size=(4, 5, 2)).astype(np.float32)
  for name, args in [("LinearScalarizer", ([1.0, 0.5],)),
                     ("ChebyshevScalarizer", ([1.0, 2.0], [0.1, -0.2])),
                     ("HyperVolumeScalarizer", ([1.0, 3.0],))]:
    j, t = getattr(jmo, name)(*args), getattr(tmo, name)(*args)
    assert t.num_of_objectives == j.num_of_objectives
    assert_close(t(torch.as_tensor(m)), j(jnp.asarray(m)), err_msg=name)
    with pytest.raises(ValueError):
      t(torch.zeros((2, 3)))
  # (twin of test_bandits.py::test_scalarizers)
  mm = torch.tensor([[1.0, 2.0], [3.0, 1.0]])
  assert_close(tmo.LinearScalarizer([1.0, 0.5])(mm), [2.0, 3.5])
  assert_close(tmo.ChebyshevScalarizer([1.0, 1.0], [0.0, 0.0])(mm),
               [1.0, 1.0])
  assert_close(tmo.HyperVolumeScalarizer([1.0, 1.0])(mm),
               [np.sqrt(2), np.sqrt(2)], rtol=1e-5)
  for bad in (lambda: tmo.LinearScalarizer([1.0]),
              lambda: tmo.ChebyshevScalarizer([1.0, 1.0], [0.0]),
              lambda: tmo.HyperVolumeScalarizer([0.0, 0.0]),
              lambda: tmo.HyperVolumeScalarizer([1.0, -1.0])):
    with pytest.raises(ValueError):
      bad()


def test_agents_raise_without_a_card_unless_asked_for_the_cpu():
  if torch.cuda.is_available():
    pytest.skip("a card is present")
  _, (ttss, tact) = _specs()
  for build in (lambda: tagents.LinUcbAgent(ttss, tact),
                lambda: tagents.Exp3Agent(ttss, tact),
                lambda: tagents.BernoulliThompsonSamplingAgent(ttss, tact),
                lambda: tagents.MixtureAgent(ttss, tact, []),
                lambda: tgaf.make_global_and_arm_feature_network(
                    tbsu.create_per_arm_observation_spec(2, 2, 3))):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      build()
