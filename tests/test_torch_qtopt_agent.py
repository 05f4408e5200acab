"""Port parity: the QtOpt agent (`agents_tpu_torch.agents.qtopt`) against the
JAX package's, alone and in the fused loop.

The JAX train step draws its CEM from ``fold_in(key(53), train_step)``
(qtopt_agent.py:166-167); `qtopt_train_draws` rebuilds those draws and the
port replays them from its state's draw source. Whole JAX states cross with
`convert.qtopt_agent_state_to_torch`. Losses, the critic, its target and
both delayed targets, Adam's moments and count and the train step agree to
rtol 1e-5 / atol 1e-6 (the second moments to atol 1e-9) in float32; the
fused loop to rtol 1e-5 / atol 1e-5. The module-level tests are the port's
counterparts of `tests/test_cql_qtopt_depth.py:293-386` and
`tests/test_more_agents.py:114-128`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agents_tpu import networks as jnetworks
from agents_tpu.agents.qtopt import QtOptAgent as JaxQtOptAgent
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu_torch.agents.qtopt import QtOptAgent
from agents_tpu_torch.networks import make_critic_network
from agents_tpu_torch.policies.wrappers import (EpsilonGreedyPolicy,
                                                GaussianPolicy)
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.trajectories.time_step import StepType
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from examples.td3_pendulum_torch import Config, build_loop
from test_torch_parity_utils import (assert_close, assert_equal,
                                     jax_cem_collect_draws, jax_cem_key_draws,
                                     jax_env_reset_draws, jax_eval_draws,
                                     jax_sample_draws, merge_draws,
                                     unit_uniforms)
from test_torch_reference_bars import jax_qtopt_loop
from test_torch_sac_agent import _experiences, _to_jax, _to_torch

torch.set_num_threads(1)

RTOL, ATOL, NU_ATOL = 1e-5, 1e-6, 1e-9
S, SAMPLES, ITERATIONS = 32, 8, 2
NETWORKS = ("q_network", "target_q_network", "target_q_network_delayed",
            "target_q_network_delayed_2")


def _specs(module):
  return (module.BoundedArraySpec((3,), np.float32, -8.0, 8.0),
          module.BoundedArraySpec((1,), np.float32, -2.0, 2.0))


def _agents(fc=(16, 16), **kwargs):
  """(JAX agent, port agent) of the same construction, CEM at 8 samples, 2
  elites and 2 iterations unless `kwargs` say otherwise."""
  kwargs = {"cem_num_samples": SAMPLES, "cem_num_elites": 2,
            "cem_num_iterations": ITERATIONS, **kwargs}
  jobs, jact = _specs(jspec)
  jagent = JaxQtOptAgent(jts.time_step_spec(jobs), jact,
                         jnetworks.make_critic_network(
                             jobs, jact, joint_fc_layer_params=fc),
                         optax.adam(1e-3), **kwargs)
  tobs, tact = _specs(tspec)
  tagent = QtOptAgent(tts.time_step_spec(tobs), tact,
                      make_critic_network(tobs, tact, joint_fc_layer_params=fc,
                                          device="cpu"),
                      lambda p: torch.optim.Adam(p, lr=1e-3), device="cpu",
                      **kwargs)
  return jagent, tagent


def qtopt_train_draws(steps, sample_batch_size, action_spec,
                      num_samples=SAMPLES, num_iterations=ITERATIONS):
  """The CEM draws of `QtOptAgent.train` at each train step in `steps`
  (from ``fold_in(key(53), step)``)."""
  return merge_draws(*(
      {site: [np.asarray(v) for v in values] for site, values in
       jax_cem_key_draws(jax.random.fold_in(jax.random.key(53), step),
                         num_iterations, num_samples, sample_batch_size,
                         action_spec).items()}
      for step in steps))


def assert_qtopt_states_close(jstate, tstate, msg, rtol=RTOL, atol=ATOL,
                              nu_atol=NU_ATOL):
  """The four critics, Adam's moments and count, and the train step of a
  port `QtOptAgentState` against a JAX one."""
  expect = convert.qtopt_agent_state_to_torch(jax.device_get(jstate))
  for field in NETWORKS:
    net = getattr(tstate, field)
    assert (net is None) == (expect[field] is None), field
    if net is not None:
      for k, v in net.state_dict().items():
        assert_close(v, expect[field][k], rtol, atol, f"{msg} {field}.{k}")
  params = [p for g in tstate.optimizer.param_groups for p in g["params"]]
  for i, p in enumerate(params):
    st, ex = tstate.optimizer.state.get(p, {}), expect["adam"][i]
    assert float(st["step"]) == float(ex["step"]), f"{msg} adam step"
    assert_close(st["exp_avg"], ex["exp_avg"], rtol, atol, f"{msg} mu {i}")
    assert_close(st["exp_avg_sq"], ex["exp_avg_sq"], rtol, nu_atol,
                 f"{msg} nu {i}")
  assert tstate.train_step == expect["train_step"]


def _n_step_experiences(n, time_dim, seed):
  """[S, time_dim] batches: `_experiences`' fields widened in time."""
  rng = np.random.RandomState(seed)
  return [dict(
      step_type=rng.choice([0, 1, 2], (S, time_dim), p=[0.2, 0.6, 0.2]).astype(
          np.int32),
      observation=(rng.randn(S, time_dim, 3) * 2).astype(np.float32),
      action=rng.uniform(-2, 2, (S, time_dim, 1)).astype(np.float32),
      next_step_type=rng.choice([0, 1, 2], (S, time_dim)).astype(np.int32),
      reward=(rng.randn(S, time_dim) * 3).astype(np.float32),
      discount=rng.choice([0.0, 1.0], (S, time_dim), p=[0.1, 0.9]).astype(
          np.float32)) for _ in range(n)]


@pytest.mark.parametrize("case", [
    dict(),
    dict(enable_td3=False),
    dict(delayed_target_update_period=2, target_update_tau=0.05,
         gamma=0.99, reward_scale_factor=0.5, gradient_clipping=0.5),
    dict(n_step_update=3, gamma=0.9, delayed_target_update_period=1)],
    ids=["defaults", "td3_off", "delayed2_tau_clip", "n_step3"])
def test_adam_steps_match_optax_from_a_converted_state(case):
  """One JAX step, the whole state carried across, then 3 more on both
  sides: losses, TD errors, every network, Adam's moments and count."""
  jagent, tagent = _agents(**case)
  time_dim = tagent.train_sequence_length
  exps = (_experiences(4, seed=6) if time_dim == 2
          else _n_step_experiences(4, time_dim, seed=6))
  jtrain = jax.jit(jagent.train)
  jstate, _ = jtrain(jagent.init(jax.random.key(0)), _to_jax(exps[0]))
  _, jact = _specs(jspec)
  draws = ReplayDraws(qtopt_train_draws(range(1, 4), S, jact))
  tstate = convert.load_qtopt_agent_state(
      tagent.init(draws=draws),
      convert.qtopt_agent_state_to_torch(jax.device_get(jstate)))
  assert_qtopt_states_close(jstate, tstate, "converted")
  for step, e in enumerate(exps[1:], start=2):
    jstate, jinfo = jtrain(jstate, _to_jax(e))
    tstate, tinfo = tagent.train(tstate, _to_torch(e))
    assert_close(tinfo.loss, jinfo.loss, RTOL, ATOL, f"step {step} loss")
    for name in ("td_loss", "td_error"):
      assert_close(getattr(tinfo.extra, name), getattr(jinfo.extra, name),
                   RTOL, ATOL, f"step {step} {name}")
    assert_qtopt_states_close(jstate, tstate, f"step {step}")
  assert all(v == 0 for v in draws.remaining().values())
  assert tstate.train_step == 4


def _traj(B=4, T=2, seed=0):
  rng = np.random.RandomState(seed)
  return ttj.Trajectory(
      step_type=torch.zeros((B, T), dtype=torch.int32),
      observation=torch.from_numpy(rng.randn(B, T, 3).astype(np.float32)),
      action=torch.from_numpy(np.clip(rng.randn(B, T, 1), -2, 2).astype(
          np.float32)),
      policy_info=(), next_step_type=torch.ones((B, T), dtype=torch.int32),
      reward=torch.ones((B, T)), discount=torch.ones((B, T)))


def _weights(net):
  return {k: v.clone() for k, v in net.state_dict().items()}


def _equal(a, b):
  return all(torch.equal(a[k], b[k]) for k in a)


def test_update_chain_follows_the_reference_order():
  """Delayed period 2, target tau 1: after step 1 only the target moved
  (to the critic); at step 2 delayed takes the old target and delayed_2 the
  old delayed (qtopt_agent.py:177-191)."""
  _, agent = _agents(delayed_target_update_period=2, target_update_period=1,
                     target_update_tau=1.0)
  state = agent.init(draws=Draws(0, "cpu"))
  delayed0 = _weights(state.target_q_network_delayed)
  s1, _ = agent.train(state, _traj())
  assert _equal(_weights(s1.target_q_network_delayed), delayed0)
  assert _equal(_weights(s1.target_q_network), _weights(s1.q_network))
  target1 = _weights(s1.target_q_network)
  delayed1 = _weights(s1.target_q_network_delayed)
  s2, _ = agent.train(s1, _traj(seed=1))
  assert _equal(_weights(s2.target_q_network_delayed), target1)
  assert _equal(_weights(s2.target_q_network_delayed_2), delayed1)
  assert not _equal(_weights(s2.target_q_network), target1)


def test_td3_off_keeps_no_delayed_targets():
  _, agent = _agents(enable_td3=False)
  state = agent.init(draws=Draws(0, "cpu"))
  assert state.target_q_network_delayed is None
  assert state.target_q_network_delayed_2 is None
  _, info = agent.train(state, _traj())
  assert bool(torch.isfinite(info.loss))
  assert tuple(info.extra.td_error.shape) == (4,)


def test_clipped_double_q_equals_the_plain_target_at_init():
  """With the delayed nets equal to the target at init, min(Q_d, Q_d2) at
  the CEM action is the CEM's own Q, to the bit."""
  _, agent = _agents()
  state = agent.init(draws=Draws(5, "cpu"))
  nsteps = tts.TimeStep(step_type=torch.ones(4, dtype=torch.int32),
                        reward=torch.zeros(4), discount=torch.ones(4),
                        observation=torch.zeros(4, 3))
  q_td3 = agent.compute_next_q_values(state, nsteps, ())
  _, q_plain = agent.policy.optimize(state.target_q_network, nsteps,
                                     Draws(5, "cpu"))
  assert_equal(q_td3, q_plain)


def test_collect_policy_is_epsilon_greedy_unless_noise_is_asked():
  _, agent = _agents()
  assert isinstance(agent.collect_policy, EpsilonGreedyPolicy)
  assert agent.collect_policy.epsilon == 0.1
  _, noisy = _agents(exploration_noise_std=0.2)
  assert isinstance(noisy.collect_policy, GaussianPolicy)
  assert noisy.collect_policy.scale == 0.2
  state = noisy.init(draws=Draws(0, "cpu"))
  step = noisy.collect_policy.action(
      noisy.collect_policy_params(state), tts.restart(torch.zeros(4, 3), 4),
      (), Draws(1, "cpu"))
  assert tuple(step.action.shape) == (4, 1)
  assert bool((step.action.abs() <= 2.0).all())


def test_n_step_update_takes_windows_of_n_plus_one():
  _, agent = _agents(n_step_update=3, gamma=0.9)
  assert agent.train_sequence_length == 4
  _, info = agent.train(agent.init(draws=Draws(0, "cpu")), _traj(T=4))
  assert bool(torch.isfinite(info.loss))


def test_out_of_graph_bellman_matches_jax():
  """in_graph_bellman_update=False reads target_q from the policy info: with
  target_q 0 the TD target is the reward, on both sides."""
  jagent, tagent = _agents(in_graph_bellman_update=False, gamma=1.0,
                           enable_td3=False)
  jstate = jagent.init(jax.random.key(0))
  tstate = convert.load_qtopt_agent_state(
      tagent.init(draws=ReplayDraws({})),
      convert.qtopt_agent_state_to_torch(jax.device_get(jstate)))
  e = _experiences(1, seed=2)[0]
  jtraj = dataclasses.replace(_to_jax(e),
                              policy_info={"target_q": jnp.zeros((S, 2))})
  ttraj = dataclasses.replace(_to_torch(e),
                              policy_info={"target_q": torch.zeros(S, 2)})
  jstate, jinfo = jax.jit(jagent.train)(jstate, jtraj)
  tstate, tinfo = tagent.train(tstate, ttraj)
  assert_close(tinfo.loss, jinfo.loss)
  assert_close(tinfo.extra.td_error, jinfo.extra.td_error)
  assert_qtopt_states_close(jstate, tstate, "out of graph")


def test_default_collect_policy_acts_as_jax():
  """Epsilon-greedy over CEM (CEM has no distribution, so its action is the
  greedy arm), on the target network: the same actions as the JAX collect
  policy from the same draws, a third of them exploring."""
  jagent, tagent = _agents(epsilon_greedy=0.3)
  jstate = jagent.init(jax.random.key(0))
  tstate = convert.load_qtopt_agent_state(
      tagent.init(draws=ReplayDraws({})),
      convert.qtopt_agent_state_to_torch(jax.device_get(jstate)))
  obs = (np.random.RandomState(3).randn(16, 3) * 2).astype(np.float32)
  key = jax.random.key(1)
  jstep = jax.jit(jagent.collect_policy.action)(
      jagent.collect_policy_params(jstate),
      jts.restart(jnp.asarray(obs), 16), (), key)
  _, jact = _specs(jspec)
  k_greedy, k_rand, k_mix = jax.random.split(key, 3)
  random_action = jspec.sample_spec_nest(jact, k_rand, outer_dims=(16,))
  coin = np.asarray(jax.random.uniform(k_mix, (16,)))
  draws = ReplayDraws(merge_draws(
      {k: [np.asarray(x) for x in v] for k, v in jax_cem_key_draws(
          k_greedy, ITERATIONS, SAMPLES, 16, jact).items()},
      {"random_action": [unit_uniforms(random_action, jact)],
       "explore": [coin]}))
  tstep = tagent.collect_policy.action(
      tagent.collect_policy_params(tstate),
      tts.restart(torch.from_numpy(obs), 16), (), draws)
  assert tagent.collect_policy_params(tstate) is tstate.target_q_network
  assert_close(tstep.action, jstep.action, 1e-6, 1e-7)
  assert 0 < int((coin < 0.3).sum()) < 16


def test_train_and_cem_policy_act_in_bounds():
  """`tests/test_more_agents.py:114`'s check: a train step with a finite
  loss, then the greedy CEM policy's actions of shape [3, 1] in bounds."""
  _, agent = _agents(gamma=0.99)
  state, info = agent.train(agent.init(draws=Draws(0, "cpu")), _traj())
  assert bool(torch.isfinite(info.loss))
  step = agent.policy.action(agent.policy_params(state),
                             tts.restart(torch.zeros(3, 3), 3), (),
                             Draws(1, "cpu"))
  assert tuple(step.action.shape) == (3, 1)
  assert bool((step.action.abs() <= 2.0).all())
  with pytest.raises(ValueError, match="lives on"):
    QtOptAgent(agent.time_step_spec, agent.action_spec, agent.q_network,
               torch.optim.Adam, device="meta")


# -- the fused loop -----------------------------------------------------------

B, CAP, SAMPLE, TRAIN_STEPS, INITIAL, ITERS = 4, 64, 16, 2, 64, 5
EPISODE, FC = 8, (16, 16)
LOOP_RTOL = LOOP_ATOL = 1e-5
FIELDS = ("step_type", "observation", "action", "next_step_type", "reward",
          "discount")


def _loop_config(**overrides):
  fields = dict(
      agent="qtopt", max_episode_steps=EPISODE, env_batch_size=B,
      replay_capacity=CAP, sample_batch_size=SAMPLE,
      train_steps_per_iteration=TRAIN_STEPS, initial_collect_steps=INITIAL,
      critic_joint_fc_layers=FC, return_buffer=5, target_update_tau=0.05,
      device="cpu")
  fields.update(overrides)
  return Config(**fields)


def _cem(loop):
  """(samples, iterations) of the loop agent's CEM: QtOpt's defaults."""
  return loop.agent.policy.num_samples, loop.agent.policy.num_iterations


def _jax_loop_draws(key, jloop):
  """Every draw of `init(key, INITIAL)` then ITERS iterations, per site."""
  env, asp = jloop.env.env, jloop.env.action_spec()
  samples, iterations = _cem(jloop)
  _, k_driver, k_collect, k_loop = jax.random.split(key, 4)
  collect = lambda k, n: jax_cem_collect_draws(  # noqa: E731
      k, n, B, asp, env, samples, iterations)
  records = [jax_env_reset_draws(k_driver, B, env), collect(k_collect, INITIAL)]
  k = k_loop
  for i in range(ITERS):
    k, k_c, k_s = jax.random.split(k, 3)
    num_valid = min(INITIAL + i + 1, CAP) - 2 + 1
    records.append(collect(k_c, 1))
    for j, k_sample in enumerate(jax.random.split(k_s, TRAIN_STEPS)):
      records.append(jax_sample_draws(k_sample, SAMPLE, num_valid, B))
      records.append(qtopt_train_draws([i * TRAIN_STEPS + j], SAMPLE, asp,
                                       samples, iterations))
  return merge_draws(*records)


@pytest.fixture(scope="module")
def loop_runs():
  cfg = _loop_config()
  jloop = jax_qtopt_loop(cfg)
  key = jax.random.key(8)

  def init_and_run(k):
    state = jloop.init(k, initial_collect_steps=INITIAL)
    return state.agent_state, jloop.run(state, ITERS)

  jagent0, (jstate, jlosses) = jax.jit(init_and_run)(key)
  tloop = build_loop(cfg)
  tloop.agent.q_network.load_state_dict(
      convert.sac_critic_params_to_state_dict(jax.device_get(
          jagent0.q_params)))
  assert _cem(tloop) == _cem(jloop) == (32, 3)
  draws = ReplayDraws(_jax_loop_draws(key, jloop))
  tstate = tloop.init(draws=draws, initial_collect_steps=INITIAL)
  tstate = dataclasses.replace(tstate, agent_state=dataclasses.replace(
      tstate.agent_state, draws=draws))
  tstate, tlosses = tloop.run(tstate, ITERS)
  return (jloop, jstate, jlosses), (tloop, tstate, tlosses), draws


def test_fused_iterations_match_jax(loop_runs):
  """Initial collect and 5 fused iterations of 2 train steps on the device
  Pendulum, episodes cut to 8 steps: losses, the replay ring, every critic,
  Adam, the collect metrics and the driver's time step."""
  (jloop, jstate, jlosses), (tloop, tstate, tlosses), draws = loop_runs
  assert all(v == 0 for v in draws.remaining().values())
  assert_close(tlosses, jlosses, LOOP_RTOL, LOOP_ATOL)
  storage = tstate.replay_state.storage
  assert tstate.replay_state.count == int(jstate.replay_state.count) == (
      INITIAL + ITERS)
  for f in FIELDS:
    a, b = getattr(storage, f), getattr(jstate.replay_state.storage, f)
    if a.dtype.is_floating_point:
      assert_close(a, b, LOOP_RTOL, LOOP_ATOL, f)
    else:
      assert_equal(a, b, f)
  assert (storage.step_type == StepType.FIRST).any()
  assert bool((storage.action.abs() <= 2.0).all())
  assert_qtopt_states_close(jstate.agent_state, tstate.agent_state, "loop",
                            LOOP_RTOL, LOOP_ATOL)
  assert tstate.agent_state.train_step == ITERS * TRAIN_STEPS
  jres, tres = jloop.results(jstate), tloop.results(tstate)
  for k in jres:
    assert_close(tres[k], jres[k], LOOP_RTOL, LOOP_ATOL, k)
  assert_close(tstate.driver_state.time_step.observation,
               jstate.driver_state.time_step.observation, LOOP_RTOL,
               LOOP_ATOL)


def test_evaluate_matches_jax(loop_runs):
  """Greedy CEM eval over exactly 6 episodes of 8 steps on both sides."""
  (jloop, jstate, _), (tloop, tstate, _), _ = loop_runs
  max_steps, key = 32, jax.random.key(11)
  jout = jloop.evaluate(jstate, key, num_episodes=6, max_steps=max_steps)
  env, asp = jloop.env.env, jloop.env.action_spec()

  def policy_keys(k):
    """The loop key's per-step policy keys (jax_driver.py:163-165)."""
    out = []
    for _ in range(max_steps):
      k, k_pol, _ = jax.random.split(k, 3)
      out.append(k_pol)
    return out

  k_init, k_run = jax.random.split(key)
  cem = merge_draws(*({s: [np.asarray(x) for x in v] for s, v in
                       jax_cem_key_draws(k, _cem(jloop)[1], _cem(jloop)[0],
                                         B, asp).items()}
                      for k in policy_keys(k_run)))
  draws = ReplayDraws(merge_draws(jax_env_reset_draws(k_init, B, env),
                                  jax_eval_draws(k_run, B, max_steps, env),
                                  cem))
  tout = tloop.evaluate(tstate, draws, num_episodes=6, max_steps=max_steps)
  assert int(tout["NumberOfEpisodes"]) == int(jout["NumberOfEpisodes"]) == 6
  for k in ("AverageReturn", "AverageEpisodeLength"):
    assert_close(tout[k], jout[k], LOOP_RTOL, LOOP_ATOL, k)


def test_loop_at_the_bench_widths_runs_on_cpu():
  """The bench point's critic, (256, 256), and CEM 32/4/3 with a short
  ring: finite losses after a few iterations of 4 train steps."""
  loop = build_loop(Config(agent="qtopt", env_batch_size=4, replay_capacity=32,
                           sample_batch_size=16, train_steps_per_iteration=4,
                           device="cpu"))
  state = loop.init(seed=0, initial_collect_steps=8)
  state, losses = loop.run(state, 3)
  assert bool(torch.isfinite(losses).all())
  assert state.agent_state.train_step == 12
  assert state.replay_state.count == 11
