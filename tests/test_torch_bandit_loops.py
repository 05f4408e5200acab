"""The bandit slice as a whole: `examples/bandits_train_eval_torch.py`'s
scenarios through the port's `OnPolicyTrainLoop` against the JAX example's
through the JAX loop, on the CPU; the learning checks of the JAX package's
bandit tests at their own configs and bars; and the example itself.

`linucb_stationary` and `neural_eps_greedy` run from the same draws (the
JAX loop's key splits re-derived and replayed) and, for the neural agent,
the same initial params (the JAX agent's init, converted). After each
window of rounds the sufficient statistics A, b and n (LinUCB; float32
sums of the same rows, rtol 1e-5 / atol 1e-6 — A and b are sums, not
solves), the losses and the regret and suboptimal-arm metrics (rtol 1e-5
/ atol 1e-6) agree, and so do the reward network's params, per tensor
within max|Δ| ≤ 1e-5 + 1e-4·max|ref| (PERF.md §2's rule for runs of Adam
steps): Adam divides each step by sqrt(v), so on a weight whose gradient
is near zero a last-ulp difference of the gradient becomes a difference
of up to the learning rate in the update. Over this run that is one
weight of the second layer, 1.9e-6 after the second step and 3.5e-6 from
the third on (rel 1.6e-5), where every other element stays within
1e-5 / 1e-6; the one-step agent tests hold elementwise.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu.bandits.metrics import RegretMetric as JaxRegretMetric
from agents_tpu.bandits.metrics import \
    SuboptimalArmsMetric as JaxSuboptimalArmsMetric
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu.train import OnPolicyTrainLoop as JaxOnPolicyTrainLoop
from agents_tpu_torch import networks as tnetworks
from agents_tpu_torch.bandits import agents as tagents
from agents_tpu_torch.bandits import environments as tenvs
from agents_tpu_torch.bandits.metrics import (RegretMetric,
                                              SuboptimalArmsMetric)
from agents_tpu_torch.bandits.policies import AbsoluteConstraint
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.train import OnPolicyTrainLoop
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import Draws
from examples import bandits_train_eval as jexample
from examples import bandits_train_eval_torch as texample
from test_torch_bandit_parity_utils import (epsilon_greedy_draws,
                                            jax_loop_draws, linucb_draws,
                                            replay)
from test_torch_parity_utils import assert_close

torch.set_num_threads(1)

SMALL = dict(env_batch_size=16, context_dim=4, num_arms=3)


def _jax_loop(cfg, scenario):
  """The JAX example's loop for `scenario` (its `train_eval` without the
  logging)."""
  env1, agent = jexample.SCENARIOS[scenario](cfg)
  env = BatchedJaxEnv(env1, batch_size=cfg.env_batch_size)
  metrics = (JaxRegretMetric(env1.optimal_reward_fn),
             JaxSuboptimalArmsMetric(env1.optimal_action_fn))
  loop = JaxOnPolicyTrainLoop(env, agent, metrics, rollout_length=2)
  return loop, env1, agent


@pytest.mark.parametrize("scenario", ["linucb_stationary",
                                      "neural_eps_greedy"])
def test_scenario_loop_matches_jax(scenario):
  windows, rounds = 2, 4
  jcfg = jexample.Config(**SMALL)
  tcfg = texample.Config(device="cpu", **SMALL)
  jloop, jenv1, jagent = _jax_loop(jcfg, scenario)
  tloop, tenv1, _ = texample.build_loop(tcfg, scenario)
  key = jax.random.key(jcfg.seed)
  policy = (linucb_draws if scenario == "linucb_stationary" else
            epsilon_greedy_draws(jenv1.action_spec()))
  records, k_agent = jax_loop_draws(jenv1, key, jcfg.env_batch_size,
                                    windows * rounds, policy)
  jstate = jloop.init(key)
  tstate = tloop.init(draws=replay(records))
  if scenario == "neural_eps_greedy":
    tstate = dataclasses.replace(
        tstate, agent_state=convert.load_reward_net_agent_state(
            tstate.agent_state, convert.reward_net_agent_state_to_torch(
                jax.device_get(jstate.agent_state),
                convert.q_params_to_state_dict)))
  run = jax.jit(lambda s, n: jloop.run(s, n), static_argnums=1)
  for w in range(windows):
    jstate = jstate.replace(metric_states=tuple(
        m.init(jcfg.env_batch_size) for m in jloop.metrics))
    tstate = dataclasses.replace(tstate, metric_states=tuple(
        m.init(tcfg.env_batch_size, "cpu") for m in tloop.metrics))
    jstate, jlosses = run(jstate, rounds)
    tstate, tlosses = tloop.run(tstate, rounds)
    assert_close(tlosses, jlosses, err_msg=f"window {w}")
    jres, tres = jloop.results(jstate), tloop.results(tstate)
    assert set(tres) == set(jres) == {"RegretMetric",
                                      "SuboptimalArmsMetric"}
    for name in jres:
      assert_close(tres[name], jres[name], err_msg=f"{name} window {w}")
    ja, ta = jstate.agent_state, tstate.agent_state
    if scenario == "linucb_stationary":
      assert_close(ta.a_mat, ja.a_mat)
      assert_close(ta.b_vec, ja.b_vec)
      assert_close(ta.num_samples, ja.num_samples)
      assert float(ta.num_samples.sum()) == jcfg.env_batch_size * rounds \
          * (w + 1)
    else:
      expected = convert.q_params_to_state_dict(jax.device_get(ja.params))
      for name, value in ta.params.state_dict().items():
        ref = expected[name].numpy()
        err = float(np.max(np.abs(value.numpy() - ref)))
        assert err <= 1e-5 + 1e-4 * float(np.max(np.abs(ref))), (name, err)
    assert ta.train_step == int(ja.train_step) == rounds * (w + 1)
  assert all(n == 0 for n in tstate.draws.remaining().values())


# -- learning, at the JAX package's tests' configs and bars -------------------

THETA = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, -1.0]], np.float32)


def _env(B=32, noise=0.05):
  return BatchedTorchEnv(tenvs.StationaryStochasticBandit(
      THETA, noise_std=noise, device="cpu"), B, device="cpu")


def _run_bandit(agent, env, iterations=30):
  """(early, late) metric windows of `iterations` rounds each
  (test_bandits.py's `_run_bandit`)."""
  metrics = (RegretMetric(env.env.optimal_reward_fn),
             SuboptimalArmsMetric(env.env.optimal_action_fn))
  loop = OnPolicyTrainLoop(env, agent, metrics, rollout_length=2,
                           device="cpu")
  state = loop.init(seed=0)
  state, _ = loop.run(state, iterations)
  early = {k: float(v) for k, v in loop.results(state).items()}
  state = dataclasses.replace(state, metric_states=tuple(
      m.init(env.batch_size, "cpu") for m in metrics))
  state, _ = loop.run(state, iterations)
  late = {k: float(v) for k, v in loop.results(state).items()}
  return early, late


def test_linucb_regret_decreases():
  env = _env()
  agent = tagents.LinUcbAgent(env.time_step_spec(), env.action_spec(),
                              alpha=1.0, device="cpu")
  early, late = _run_bandit(agent, env)
  assert late["RegretMetric"] < early["RegretMetric"]
  assert late["SuboptimalArmsMetric"] < 0.35


def test_lints_learns():
  env = _env()
  agent = tagents.LinearThompsonSamplingAgent(
      env.time_step_spec(), env.action_spec(), alpha=0.5, device="cpu")
  _, late = _run_bandit(agent, env)
  assert late["SuboptimalArmsMetric"] < 0.5


def test_neural_eps_greedy_learns():
  env = _env()
  net = tnetworks.make_q_network(env.time_step_spec().observation,
                                 env.action_spec(), fc_layer_params=(32,),
                                 device="cpu")
  agent = tagents.NeuralEpsilonGreedyAgent(
      env.time_step_spec(), env.action_spec(), net,
      lambda p: torch.optim.Adam(p, lr=1e-2), epsilon=0.1, device="cpu")
  early, late = _run_bandit(agent, env, iterations=60)
  assert late["RegretMetric"] < early["RegretMetric"] + 0.05


def test_falcon_and_neural_linucb_run():
  env = _env(B=8)
  net = tnetworks.make_q_network(env.time_step_spec().observation,
                                 env.action_spec(), fc_layer_params=(16,),
                                 device="cpu")
  falcon = tagents.NeuralFalconAgent(
      env.time_step_spec(), env.action_spec(), net,
      lambda p: torch.optim.Adam(p, lr=1e-2), device="cpu")
  state = falcon.init()
  step = tts.restart(torch.zeros((4, 2)), batch_size=4)
  a = falcon.collect_policy.action(falcon.collect_policy_params(state), step,
                                   (), Draws(1, "cpu"))
  assert a.action.shape == (4,)
  from agents_tpu_torch.networks.encoding_network import \
      make_encoding_network
  enc = make_encoding_network(env.time_step_spec().observation,
                              fc_layer_params=(8,), device="cpu")
  agent = tagents.NeuralLinUcbAgent(
      env.time_step_spec(), env.action_spec(), enc, encoding_dim=8,
      optimizer_fn=lambda p: torch.optim.Adam(p, lr=1e-2),
      encoding_phase_steps=5, device="cpu")
  loop = OnPolicyTrainLoop(env, agent, (), rollout_length=2, device="cpu")
  state, losses = loop.run(loop.init(seed=0), 10)
  assert bool(torch.isfinite(losses).all())
  assert state.agent_state.train_step == 10


def test_bernoulli_ts_finds_best_arm():
  env = BatchedTorchEnv(tenvs.BernoulliBandit([0.1, 0.8, 0.3], device="cpu"),
                        16, device="cpu")
  agent = tagents.BernoulliThompsonSamplingAgent(
      env.time_step_spec(), env.action_spec(), device="cpu")
  loop = OnPolicyTrainLoop(env, agent, (), rollout_length=2, device="cpu")
  state, _ = loop.run(loop.init(seed=0), 40)
  ag = state.agent_state
  assert int(torch.argmax(ag.alpha / (ag.alpha + ag.beta))) == 1


def test_exp3_prefers_best_arm():
  env = BatchedTorchEnv(tenvs.BernoulliBandit([0.2, 0.9], device="cpu"), 8,
                        device="cpu")
  agent = tagents.Exp3Agent(env.time_step_spec(), env.action_spec(),
                            learning_rate=0.01, device="cpu")
  loop = OnPolicyTrainLoop(env, agent, (), rollout_length=2, device="cpu")
  state, _ = loop.run(loop.init(seed=0), 50)
  w = state.agent_state.log_weights
  assert float(w[1]) > float(w[0])


def test_wheel_bandit_env_contexts_lie_in_the_disk():
  env = BatchedTorchEnv(tenvs.WheelBandit(device="cpu"), 4, device="cpu")
  _, step = env.reset(Draws(0, "cpu"))
  assert float((step.observation ** 2).sum(-1).max()) <= 1.0 + 1e-5


def test_linucb_learns_on_movielens():
  ratings = tenvs.synthetic_ratings_matrix(60, 30, rank=3, seed=0)
  env = BatchedTorchEnv(tenvs.MovieLensBandit(
      data_matrix=ratings, rank_k=3, num_movies=10, device="cpu"), 16,
                        device="cpu")
  agent = tagents.LinUcbAgent(env.time_step_spec(), env.action_spec(),
                              alpha=1.0, device="cpu")
  metric = RegretMetric(env.env.optimal_reward_fn)
  loop = OnPolicyTrainLoop(env, agent, (metric,), rollout_length=2,
                           device="cpu")
  state, _ = loop.run(loop.init(seed=0), 30)
  early = float(metric.result(state.metric_states[0]))
  state = dataclasses.replace(state,
                              metric_states=(metric.init(16, "cpu"),))
  state, _ = loop.run(state, 30)
  assert float(metric.result(state.metric_states[0])) < early


def test_constrained_greedy_agent_masks_infeasible_arm():
  """(twin of test_bandit_constraints_movielens) the reward prefers arm 0,
  the trained constraint marks it infeasible, the policy never takes it."""
  obs_spec = tspec.ArraySpec((2,), np.float32, "observation")
  tss = tts.time_step_spec(obs_spec)
  act = tspec.BoundedArraySpec((), np.int32, 0, 2, "action")
  g = torch.Generator().manual_seed(0)
  cnet = tnetworks.make_q_network(obs_spec, act, fc_layer_params=(16,),
                                  device="cpu", generator=g)
  rnet = tnetworks.make_q_network(obs_spec, act, fc_layer_params=(16,),
                                  device="cpu", generator=g)
  constraint = AbsoluteConstraint(tss, act, cnet, comparator_fn=torch.gt,
                                  absolute_value=0.5)
  agent = tagents.GreedyRewardPredictionAgent(
      tss, act, rnet, lambda p: torch.optim.Adam(p, lr=5e-2),
      constraints=(constraint,), device="cpu")
  state = agent.init()
  for i in range(150):
    rng = np.random.default_rng(i)
    obs = torch.as_tensor(rng.normal(size=(64, 2)).astype(np.float32))
    action = torch.as_tensor(rng.integers(0, 3, size=(64,)))
    batch = ttj.Trajectory(
        step_type=torch.zeros(64, dtype=torch.int32), observation=obs,
        action=action, policy_info=(),
        next_step_type=torch.full((64,), 2, dtype=torch.int32),
        reward={"reward": (action == 0).float(),
                "constraint": (action != 0).float()[:, None]},
        discount=torch.ones(64))
    state, info = agent.train(state, batch)
  assert float(info.loss) < 0.05
  obs = torch.as_tensor(np.random.default_rng(999).normal(
      size=(32, 2)).astype(np.float32))
  feas = constraint(state.params["constraints"][0], obs)
  assert bool((feas[:, 0] == 0).all()) and bool((feas[:, 1:] == 1).all())
  step = tts.restart(obs, batch_size=32)
  assert bool((agent.policy.action(state.params, step, (),
                                   Draws(7, "cpu")).action != 0).all())
  preds, _ = rnet(obs)
  assert bool((torch.argmax(preds, -1) == 0).all())
  assert bool((agent.policy.distribution(state.params, step).action.mode()
               != 0).all())


# -- the example --------------------------------------------------------------

def test_example_has_the_jax_scenarios_and_config():
  assert list(texample.SCENARIOS) == list(jexample.SCENARIOS)
  jfields = {f.name: f.default for f in dataclasses.fields(jexample.Config)}
  tfields = {f.name: f.default for f in dataclasses.fields(texample.Config)}
  assert set(tfields) == set(jfields) | {"device"}
  for name, value in jfields.items():
    if name != "root_dir":
      assert tfields[name] == value, name
  assert tfields["device"] == "cuda"


@pytest.mark.parametrize("scenario", list(texample.SCENARIOS))
def test_every_scenario_runs_a_few_rounds(scenario, tmp_path):
  cfg = texample.Config(env_batch_size=8, num_rounds=4, log_interval=2,
                        root_dir=str(tmp_path), device="cpu")
  state, records = texample.train_eval(cfg, scenario)
  lines = [json.loads(l) for l in
           (tmp_path / f"{scenario}.jsonl").read_text().splitlines()]
  assert lines == records and [r["round"] for r in lines] == [2, 4]
  for rec in lines:
    assert rec["scenario"] == scenario and rec["rounds_per_s"] > 0
    assert all(np.isfinite(v) for k, v in rec.items()
               if k not in ("scenario",))
  jenv1, _ = jexample.SCENARIOS[scenario](jexample.Config())
  tenv1, _ = texample.SCENARIOS[scenario](cfg)
  # The port's metrics are the JAX example's: defined where its env
  # defines them.
  for fn, name in (("optimal_reward_fn", "RegretMetric"),
                   ("optimal_action_fn", "SuboptimalArmsMetric")):
    try:
      getattr(jenv1, fn)(jax.tree_util.tree_map(
          lambda s: jnp.zeros((1,) + tuple(s.shape), s.dtype),
          jenv1.observation_spec()))
      has = True
    except (NotImplementedError, AttributeError):
      has = False
    assert (name in lines[0]) == has, (scenario, name)
  assert state.agent_state.train_step == 4


def test_example_command_line(tmp_path, capsys):
  texample.main(["--scenario=exp3", "--device", "cpu",
                 f"--cfg.root_dir={tmp_path}", "--cfg.num_rounds=3",
                 "--cfg.log_interval=3", "--cfg.env_batch_size=4"])
  rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  assert rec["scenario"] == "exp3" and rec["round"] == 3
  texample.main(["--list"])
  assert capsys.readouterr().out.split() == list(texample.SCENARIOS)
  with pytest.raises(SystemExit):
    texample.main(["--scenario=nope"])
