"""The SAC slice as a whole: `agents_tpu_torch.train.FusedTrainLoop` with
`SacAgent` on the device Pendulum against the JAX package's
`FusedTrainLoop`, and greedy `evaluate`.

Both loops start from the same actor and critics (the JAX side's flax
init, carried across by `convert`) and the same draws: every stochastic
site's draws (the Pendulum resets, the actor's collect noise, the replay
samples and the train steps' normals) are re-derived from the JAX loop's
own key splits and replayed into the port. Episodes are cut to 8 steps so
the run crosses auto-resets and boundary frames, and the ring of 64
wraps. After the initial collect and 5 fused iterations of 2 train steps,
losses, the five parameter sets, log alpha, the Adam moments, the replay
ring and the collect metrics agree to rtol 1e-5 / atol 1e-5 (the second
moments to atol 1e-9); step types exactly.
"""
import dataclasses

import jax
import optax
import pytest
import torch

from agents_tpu import metrics as jmetrics
from agents_tpu import networks as jnetworks
from agents_tpu.agents.sac import SacAgent as JaxSacAgent
from agents_tpu.environments.classic.pendulum import Pendulum as JaxPendulum
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu.replay_buffers import UniformReplay as JaxUniformReplay
from agents_tpu.train import FusedTrainLoop as JaxFusedTrainLoop
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch.trajectories.time_step import StepType
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import ReplayDraws
from examples.sac_pendulum_torch import Config, build_loop
from test_torch_parity_utils import (assert_close, assert_equal,
                                     jax_collect_draws, jax_env_reset_draws,
                                     jax_eval_draws, jax_sac_train_draws,
                                     jax_sample_draws, merge_draws)
from test_torch_sac_agent import assert_sac_states_close

torch.set_num_threads(1)

B, CAP, S, TRAIN_STEPS, INITIAL, ITERS = 4, 64, 16, 2, 64, 5
EPISODE, FC = 8, (16, 16)
HP = dict(target_update_tau=0.005, gamma=0.99, reward_scale_factor=1.0)
RTOL = ATOL = 1e-5
FIELDS = ("step_type", "observation", "action", "next_step_type", "reward",
          "discount")


def _config(**overrides):
  """The port's loop: the example's construction at the test's size."""
  fields = dict(
      max_episode_steps=EPISODE, env_batch_size=B, replay_capacity=CAP,
      sample_batch_size=S, train_steps_per_iteration=TRAIN_STEPS,
      initial_collect_steps=INITIAL, actor_fc_layers=FC,
      critic_joint_fc_layers=FC, return_buffer=5, device="cpu", **HP)
  fields.update(overrides)
  return Config(**fields)


def _jax_loop():
  env = BatchedJaxEnv(JaxPendulum(EPISODE), batch_size=B)
  tss, asp = env.time_step_spec(), env.action_spec()
  agent = JaxSacAgent(
      tss, asp,
      critic_network=jnetworks.make_critic_network(
          tss.observation, asp, joint_fc_layer_params=FC),
      actor_network=jnetworks.make_sac_actor_network(
          tss.observation, asp, fc_layer_params=FC),
      actor_optimizer=optax.adam(3e-4), critic_optimizer=optax.adam(3e-4),
      alpha_optimizer=optax.adam(3e-4), **HP)
  replay = JaxUniformReplay(jtj.trajectory_spec(tss, asp), B, CAP)
  return JaxFusedTrainLoop(env, agent, replay,
                           metrics=jmetrics.standard_collect_metrics(5),
                           sample_batch_size=S,
                           train_steps_per_iteration=TRAIN_STEPS)


def _jax_loop_draws(key, jloop):
  """Every draw of `init(key, INITIAL)` then ITERS iterations, per site
  (fused_loop.py:84, :111, :171)."""
  env, asp = jloop.env.env, jloop.env.action_spec()
  _, k_driver, k_collect, k_loop = jax.random.split(key, 4)
  records = [jax_env_reset_draws(k_driver, B, env),
             jax_collect_draws(k_collect, INITIAL, B, asp, env, "actor")]
  k = k_loop
  for i in range(ITERS):
    k, k_c, k_s = jax.random.split(k, 3)
    num_valid = min(INITIAL + i + 1, CAP) - 2 + 1
    records.append(jax_collect_draws(k_c, 1, B, asp, env, "actor"))
    for j, k_sample in enumerate(jax.random.split(k_s, TRAIN_STEPS)):
      records.append(jax_sample_draws(k_sample, S, num_valid, B))
      records.append(jax_sac_train_draws(i * TRAIN_STEPS + j, S, asp))
  return merge_draws(*records)


@pytest.fixture(scope="module")
def runs():
  jloop = _jax_loop()
  key = jax.random.key(7)

  def init_and_run(k):
    state = jloop.init(k, initial_collect_steps=INITIAL)
    return state.agent_state, jloop.run(state, ITERS)

  jagent0, (jstate, jlosses) = jax.jit(init_and_run)(key)
  jagent0 = jax.device_get(jagent0)

  tloop = build_loop(_config())
  agent = tloop.agent
  for net, params, fn in (
      (agent.actor_network, jagent0.actor_params,
       convert.sac_actor_params_to_state_dict),
      (agent.critic_network, jagent0.critic1_params,
       convert.sac_critic_params_to_state_dict),
      (agent.critic_network_2, jagent0.critic2_params,
       convert.sac_critic_params_to_state_dict)):
    net.load_state_dict(fn(params))
  draws = ReplayDraws(_jax_loop_draws(key, jloop))
  tstate = tloop.init(draws=draws, initial_collect_steps=INITIAL)
  tstate = dataclasses.replace(tstate, agent_state=dataclasses.replace(
      tstate.agent_state, draws=draws))
  tstate, tlosses = tloop.run(tstate, ITERS)
  return (jloop, jstate, jlosses), (tloop, tstate, tlosses), draws


def test_sac_fused_iterations_match_jax(runs):
  (jloop, jstate, jlosses), (tloop, tstate, tlosses), draws = runs
  assert all(v == 0 for v in draws.remaining().values())
  assert_close(tlosses, jlosses, RTOL, ATOL)

  storage = tstate.replay_state.storage
  assert tstate.replay_state.count == int(jstate.replay_state.count) == (
      INITIAL + ITERS)
  for f in FIELDS:
    a, b = getattr(storage, f), getattr(jstate.replay_state.storage, f)
    if a.dtype.is_floating_point:
      assert_close(a, b, RTOL, ATOL, f)
    else:
      assert_equal(a, b, f)
  assert tuple(storage.action.shape) == (CAP, B, 1)
  assert (storage.step_type == StepType.LAST).any()
  assert (storage.next_step_type == StepType.LAST).any()
  assert bool((storage.action.abs() <= 2.0).all())

  assert_sac_states_close(jstate.agent_state, tstate.agent_state, "loop",
                          RTOL, ATOL)
  assert tstate.agent_state.train_step == ITERS * TRAIN_STEPS

  jres, tres = jloop.results(jstate), tloop.results(tstate)
  assert set(jres) == set(tres)
  for k in jres:
    assert_close(tres[k], jres[k], RTOL, ATOL, k)
  # An episode of 8 steps and its boundary frame take 9 frames per row.
  assert float(tres["NumberOfEpisodes"]) == (
      (INITIAL + ITERS) // (EPISODE + 1) * B)
  assert_close(tstate.driver_state.time_step.observation,
               jstate.driver_state.time_step.observation, RTOL, ATOL)


def test_sac_evaluate_matches_jax(runs):
  """Greedy eval over exactly 6 episodes of 8 steps on both sides."""
  (jloop, jstate, _), (tloop, tstate, _), _ = runs
  max_steps, key = 32, jax.random.key(11)
  jout = jloop.evaluate(jstate, key, num_episodes=6, max_steps=max_steps)
  env = jloop.env.env
  k_init, k_run = jax.random.split(key)
  draws = ReplayDraws(merge_draws(jax_env_reset_draws(k_init, B, env),
                                  jax_eval_draws(k_run, B, max_steps, env)))
  tout = tloop.evaluate(tstate, draws, num_episodes=6, max_steps=max_steps)
  assert int(tout["NumberOfEpisodes"]) == int(jout["NumberOfEpisodes"]) == 6
  for k in ("AverageReturn", "AverageEpisodeLength"):
    assert_close(tout[k], jout[k], RTOL, ATOL, k)
  assert float(tout["AverageEpisodeLength"]) == EPISODE


def test_sac_loop_at_the_bench_widths_runs_on_cpu():
  """The bench point's networks, (256, 256), with a short ring: finite
  losses and log alpha after a few iterations of 4 train steps."""
  loop = build_loop(Config(env_batch_size=4, replay_capacity=32,
                           sample_batch_size=16, train_steps_per_iteration=4,
                           device="cpu"))
  state = loop.init(seed=0, initial_collect_steps=8)
  state, losses = loop.run(state, 3)
  assert bool(torch.isfinite(losses).all())
  assert bool(torch.isfinite(state.agent_state.log_alpha))
  assert state.agent_state.train_step == 12
  assert state.replay_state.count == 11
