"""The TD3/DDPG slice as a whole: `agents_tpu_torch.train.FusedTrainLoop`
with `Td3Agent` (Gaussian exploration) or `DdpgAgent` (OU exploration, its
state carried through the driver) on the device Pendulum against the JAX
package's `FusedTrainLoop`, and greedy `evaluate`.

Both loops start from the same actor and critics (the JAX side's flax
init, carried across by `convert`) and the same draws: the Pendulum
resets, the collect noise, the replay samples and TD3's smoothing normals
are re-derived from the JAX loop's own key splits and replayed into the
port. Episodes are cut to 8 steps, so the run crosses auto-resets (where
the OU state restarts) and boundary frames, and the ring of 64 wraps.
After the initial collect and 5 fused iterations of 2 train steps (TD3's
actor stepping on every second), losses, every network, the Adams'
moments and counts, the replay ring, the OU state and the collect metrics
agree to rtol 1e-5 / atol 1e-5 (the second moments to atol 1e-9); step
types exactly. The loops run from key 8: from key 7, at train step 8 a
ReLU pre-activation of critic 2 lies within rounding of 0, XLA's and
torch's summation orders put it on either side, and critic 2 parts by
7e-5 while everything else holds to 1e-7.
"""
import dataclasses

import jax
import pytest
import torch

from agents_tpu_torch.trajectories.time_step import StepType
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import ReplayDraws
from examples.td3_pendulum_torch import Config, build_loop
from test_torch_parity_utils import (assert_close, assert_equal,
                                     jax_collect_draws, jax_env_reset_draws,
                                     jax_eval_draws, jax_sample_draws,
                                     merge_draws)
from test_torch_reference_bars import jax_td3_loop
from test_torch_td3_ddpg_agent import assert_states_close, td3_target_draws

torch.set_num_threads(1)

B, CAP, S, TRAIN_STEPS, INITIAL, ITERS = 4, 64, 16, 2, 64, 5
EPISODE, FC = 8, (16, 16)
RTOL = ATOL = 1e-5
FIELDS = ("step_type", "observation", "action", "next_step_type", "reward",
          "discount")
COLLECT = {"td3": "gaussian", "ddpg": "ou"}


def _config(agent, **overrides):
  """The example's loop at the test's size."""
  fields = dict(
      agent=agent, max_episode_steps=EPISODE, env_batch_size=B,
      replay_capacity=CAP, sample_batch_size=S,
      train_steps_per_iteration=TRAIN_STEPS, initial_collect_steps=INITIAL,
      actor_fc_layers=FC, critic_joint_fc_layers=FC, return_buffer=5,
      target_update_tau=0.05, exploration_noise_std=1.5, ou_stddev=1.0,
      device="cpu")
  fields.update(overrides)
  return Config(**fields)


def _jax_loop_draws(key, jloop, agent):
  """Every draw of `init(key, INITIAL)` then ITERS iterations, per site
  (fused_loop.py:84, :111, :171)."""
  env, asp = jloop.env.env, jloop.env.action_spec()
  _, k_driver, k_collect, k_loop = jax.random.split(key, 4)
  policy = COLLECT[agent]
  records = [jax_env_reset_draws(k_driver, B, env),
             jax_collect_draws(k_collect, INITIAL, B, asp, env, policy)]
  k = k_loop
  for i in range(ITERS):
    k, k_c, k_s = jax.random.split(k, 3)
    num_valid = min(INITIAL + i + 1, CAP) - 2 + 1
    records.append(jax_collect_draws(k_c, 1, B, asp, env, policy))
    for j, k_sample in enumerate(jax.random.split(k_s, TRAIN_STEPS)):
      records.append(jax_sample_draws(k_sample, S, num_valid, B))
      if agent == "td3":
        records.append(td3_target_draws([i * TRAIN_STEPS + j], S))
  return merge_draws(*records)


def _load(agent, jagent0):
  networks = [(agent.actor_network, jagent0.actor_params,
               convert.deterministic_actor_params_to_state_dict)]
  if hasattr(jagent0, "critic1_params"):
    networks += [(agent.critic_network, jagent0.critic1_params,
                  convert.sac_critic_params_to_state_dict),
                 (agent.critic_network_2, jagent0.critic2_params,
                  convert.sac_critic_params_to_state_dict)]
  else:
    networks += [(agent.critic_network, jagent0.critic_params,
                  convert.sac_critic_params_to_state_dict)]
  for net, params, fn in networks:
    net.load_state_dict(fn(params))


def _runs(agent):
  cfg = _config(agent)
  jloop = jax_td3_loop(cfg)
  key = jax.random.key(8)

  def init_and_run(k):
    state = jloop.init(k, initial_collect_steps=INITIAL)
    return state.agent_state, jloop.run(state, ITERS)

  jagent0, (jstate, jlosses) = jax.jit(init_and_run)(key)
  tloop = build_loop(cfg)
  _load(tloop.agent, jax.device_get(jagent0))
  draws = ReplayDraws(_jax_loop_draws(key, jloop, agent))
  tstate = tloop.init(draws=draws, initial_collect_steps=INITIAL)
  if agent == "td3":
    tstate = dataclasses.replace(tstate, agent_state=dataclasses.replace(
        tstate.agent_state, draws=draws))
  tstate, tlosses = tloop.run(tstate, ITERS)
  return (jloop, jstate, jlosses), (tloop, tstate, tlosses), draws


@pytest.fixture(scope="module", params=["td3", "ddpg"])
def runs(request):
  return request.param, _runs(request.param)


def test_fused_iterations_match_jax(runs):
  agent, ((jloop, jstate, jlosses), (tloop, tstate, tlosses), draws) = runs
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
  assert (storage.step_type == StepType.FIRST).any()
  assert (storage.next_step_type == StepType.LAST).any()
  assert bool((storage.action.abs() <= 2.0).all())
  assert bool((storage.action.abs() == 2.0).any())   # the noise clips

  assert_states_close(agent, jstate.agent_state, tstate.agent_state, "loop",
                      RTOL, ATOL)
  assert tstate.agent_state.train_step == ITERS * TRAIN_STEPS
  if agent == "ddpg":
    # The OU state rides in the driver state, reset at each FIRST row.
    assert_close(tstate.driver_state.policy_state[1][0],
                 jstate.driver_state.policy_state[1][0], RTOL, ATOL)
    assert bool((tstate.driver_state.policy_state[1][0] != 0).all())

  jres, tres = jloop.results(jstate), tloop.results(tstate)
  assert set(jres) == set(tres)
  for k in jres:
    assert_close(tres[k], jres[k], RTOL, ATOL, k)
  assert_close(tstate.driver_state.time_step.observation,
               jstate.driver_state.time_step.observation, RTOL, ATOL)


def test_evaluate_matches_jax(runs):
  """Greedy eval of the deterministic actor over exactly 6 episodes of 8
  steps on both sides."""
  _, ((jloop, jstate, _), (tloop, tstate, _), _) = runs
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


@pytest.mark.parametrize("agent", ["td3", "ddpg"])
def test_loop_at_the_bench_widths_runs_on_cpu(agent):
  """The bench point's networks, (256, 256), with a short ring: finite
  losses after a few iterations of 4 train steps."""
  loop = build_loop(Config(agent=agent, env_batch_size=4, replay_capacity=32,
                           sample_batch_size=16, train_steps_per_iteration=4,
                           dqda_clipping=0.5 if agent == "ddpg" else 0.0,
                           device="cpu"))
  state = loop.init(seed=0, initial_collect_steps=8)
  state, losses = loop.run(state, 3)
  assert bool(torch.isfinite(losses).all())
  assert state.agent_state.train_step == 12
  assert state.replay_state.count == 11
