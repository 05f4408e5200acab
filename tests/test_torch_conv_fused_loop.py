"""The pixel slice as a whole: `agents_tpu_torch.train.FusedTrainLoop` with a
conv Q-network on SyntheticPixels against the JAX package's
`FusedTrainLoop`, greedy `evaluate`, a bfloat16 run, and the Catch
learning check.

Both loops start from the same Q-network params (the JAX side's flax
init, carried across by `convert`) and the same draws: every stochastic
site's draws are re-derived from the JAX loop's own key splits and
replayed into the port. After the initial collect (which ends an episode
and wraps the ring) and 5 fused iterations, losses, online and target
params, the replay ring and the collect metrics agree to rtol 1e-5 /
atol 1e-5; uint8 observations, actions, step types and counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agents_tpu import metrics as jmetrics
from agents_tpu import networks as jnetworks
from agents_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from agents_tpu.environments.classic.synthetic_pixels import \
    SyntheticPixels as JaxSyntheticPixels
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu.replay_buffers import UniformReplay as JaxUniformReplay
from agents_tpu.train import FusedTrainLoop as JaxFusedTrainLoop
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu.utils import common as jcommon
from agents_tpu_torch.trajectories.time_step import StepType
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import ReplayDraws
from examples.dqn_pixels_torch import CATCH, Config, build_loop
from test_torch_parity_utils import (assert_close, assert_equal,
                                     env_reset_site, jax_collect_draws,
                                     jax_env_reset_draws, jax_eval_draws,
                                     jax_sample_draws, merge_draws)

torch.set_num_threads(1)

B, CAP, S, INITIAL, ITERS = 4, 16, 8, 16, 5
ENV = dict(size=12, frames=2, num_actions=4, horizon=16)
CONV, FC = ((8, 3, 2), (8, 3, 1)), (32,)
HP = dict(epsilon_greedy=0.1, gamma=0.99, target_update_tau=1.0,
          target_update_period=2)
RTOL = ATOL = 1e-5
FIELDS = ("step_type", "observation", "action", "next_step_type", "reward",
          "discount")


def _config(**overrides):
  """The port's loop: the example's construction at the test's size."""
  fields = dict(
      env="pixels", pixels_size=ENV["size"], pixels_frames=ENV["frames"],
      pixels_actions=ENV["num_actions"], pixels_horizon=ENV["horizon"],
      env_batch_size=B, replay_capacity=CAP, sample_batch_size=S,
      initial_collect_steps=INITIAL, conv_layer_params=CONV,
      fc_layer_params=FC, dtype="float32", learning_rate=1e-3,
      adam_eps=1e-8, return_buffer=5, td_loss="huber", device="cpu", **HP)
  fields.update(overrides)
  return Config(**fields)


def _jax_loop():
  env = BatchedJaxEnv(JaxSyntheticPixels(**ENV), batch_size=B)
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = jnetworks.make_q_network(
      tss.observation, asp, conv_layer_params=CONV, fc_layer_params=FC,
      preprocessing=lambda x: x.astype(jnp.float32) / 255.0)
  agent = JaxDqnAgent(tss, asp, qnet, optax.adam(1e-3),
                      td_errors_loss_fn=jcommon.element_wise_huber_loss, **HP)
  replay = JaxUniformReplay(jtj.trajectory_spec(tss, asp), B, CAP)
  return JaxFusedTrainLoop(env, agent, replay,
                           metrics=jmetrics.standard_collect_metrics(5),
                           sample_batch_size=S)


def _jax_loop_draws(key, jloop):
  """Every draw of `init(key, INITIAL)` then ITERS iterations, per site."""
  env, asp = jloop.env.env, jloop.env.action_spec()
  _, k_driver, k_collect, k_loop = jax.random.split(key, 4)
  records = [jax_env_reset_draws(k_driver, B, env),
             jax_collect_draws(k_collect, INITIAL, B, asp, env)]
  k = k_loop
  for i in range(ITERS):
    k, k_c, k_s = jax.random.split(k, 3)
    num_valid = min(INITIAL + i + 1, CAP) - 2 + 1
    records.append(jax_collect_draws(k_c, 1, B, asp, env))
    records.append(jax_sample_draws(jax.random.split(k_s, 1)[0], S,
                                    num_valid, B))
  return merge_draws(*records)


@pytest.fixture(scope="module")
def runs():
  jloop = _jax_loop()
  key = jax.random.key(7)

  def init_and_run(k):
    state = jloop.init(k, initial_collect_steps=INITIAL)
    return state.agent_state.q_params, jloop.run(state, ITERS)

  q0, (jstate, jlosses) = jax.jit(init_and_run)(key)

  tloop = build_loop(_config())
  tloop.agent.q_network.load_state_dict(
      convert.q_params_to_state_dict(jax.device_get(q0)))
  draws = ReplayDraws(_jax_loop_draws(key, jloop))
  tstate = tloop.init(draws=draws, initial_collect_steps=INITIAL)
  tstate, tlosses = tloop.run(tstate, ITERS)
  return (jloop, jstate, jlosses), (tloop, tstate, tlosses), draws


def test_conv_fused_iterations_match_jax(runs):
  (jloop, jstate, jlosses), (tloop, tstate, tlosses), draws = runs
  assert all(v == 0 for v in draws.remaining().values())
  assert_close(tlosses, jlosses, rtol=RTOL, atol=ATOL)

  storage = tstate.replay_state.storage
  assert tstate.replay_state.count == int(jstate.replay_state.count) == (
      INITIAL + ITERS)
  for f in FIELDS:
    a, b = getattr(storage, f), getattr(jstate.replay_state.storage, f)
    if a.dtype.is_floating_point:
      assert_close(a, b, rtol=RTOL, atol=ATOL, err_msg=f)
    else:
      assert_equal(a, b, f)
  assert storage.observation.dtype == torch.uint8
  assert tuple(storage.observation.shape) == (CAP, B, 12, 12, 2)
  assert (storage.step_type == StepType.LAST).any()
  assert (storage.step_type == StepType.FIRST).any()

  ja = jax.device_get(jstate.agent_state)
  for tree, net in ((ja.q_params, tstate.agent_state.q_network),
                    (ja.target_q_params, tstate.agent_state.target_q_network)):
    expect = convert.q_params_to_state_dict(tree)
    for k, v in net.state_dict().items():
      assert_close(v, expect[k], rtol=RTOL, atol=ATOL, err_msg=k)
  assert tstate.agent_state.train_step == int(ja.train_step) == ITERS

  jres, tres = jloop.results(jstate), tloop.results(tstate)
  assert set(jres) == set(tres)
  for k in jres:
    assert_close(tres[k], jres[k], rtol=RTOL, atol=ATOL, err_msg=k)
  assert_equal(tstate.driver_state.time_step.observation,
               jstate.driver_state.time_step.observation)


def test_conv_evaluate_matches_jax(runs):
  """Greedy eval over exactly 6 episodes of 16 steps on both sides."""
  (jloop, jstate, _), (tloop, tstate, _), _ = runs
  max_steps, key = 64, jax.random.key(11)
  jout = jloop.evaluate(jstate, key, num_episodes=6, max_steps=max_steps)
  env = jloop.env.env
  k_init, k_run = jax.random.split(key)
  draws = ReplayDraws(merge_draws(jax_env_reset_draws(k_init, B, env),
                                  jax_eval_draws(k_run, B, max_steps, env)))
  assert env_reset_site(env) == "pixels_target"
  tout = tloop.evaluate(tstate, draws, num_episodes=6, max_steps=max_steps)
  assert int(tout["NumberOfEpisodes"]) == int(jout["NumberOfEpisodes"]) == 6
  for k in ("AverageReturn", "AverageEpisodeLength"):
    assert_close(tout[k], jout[k], err_msg=k)


def test_bf16_run_keeps_uint8_storage_and_finite_losses():
  """Twin of `tests/test_synthetic_pixels.py::test_conv_dqn_iteration_runs`:
  bfloat16 compute, frames scaled by 1/255."""
  loop = build_loop(_config(dtype="bfloat16", replay_capacity=64,
                            target_update_period=1))
  state = loop.init(seed=0, initial_collect_steps=8)
  state, losses = loop.run(state, 10)
  assert bool(torch.isfinite(losses).all())
  assert state.replay_state.storage.observation.dtype == torch.uint8
  assert all(p.dtype == torch.float32
             for p in state.agent_state.q_network.parameters())


def test_conv_dqn_learns_catch():
  """Twin of `tests/test_catch_conv_e2e.py::test_conv_dqn_learns_catch`:
  the example's ``--env=catch`` config reaches a last-100 return above
  0.3 within 2,400 iterations (random play averages about -0.6)."""
  loop = build_loop(Config(**CATCH, device="cpu"))
  state = loop.init(seed=0, initial_collect_steps=32)
  ret = -1.0
  for _ in range(6):
    state, losses = loop.run(state, 400)
    ret = float(loop.results(state)["AverageReturn"])
    if ret > 0.5:
      break
  assert bool(torch.isfinite(losses).all())
  assert ret > 0.3, f"conv DQN failed to learn Catch (return {ret})"
