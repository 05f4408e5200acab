"""The slice as a whole: `agents_tpu_torch.train.FusedTrainLoop` against the
JAX package's `FusedTrainLoop` on CartPole, and greedy `evaluate`.

Both loops start from the same Q-network params (the JAX side's flax
init, carried across by `convert`) and the same draws: every stochastic
site's draws are re-derived from the JAX loop's own key splits
(fused_loop.py:84,111,171; jax_driver.py:65,80; uniform_replay.py:164)
and replayed into the port. After the initial collect and 5 fused
iterations, losses, online and target params, the replay ring and the
collect metrics agree: floats to rtol 1e-5 / atol 1e-6, step types,
actions and counts exactly.
"""
import warnings

import jax
import optax
import pytest
import torch

from agents_tpu import metrics as jmetrics
from agents_tpu import networks as jnetworks
from agents_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from agents_tpu.environments.classic.cartpole import CartPole as JaxCartPole
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu.replay_buffers import UniformReplay as JaxUniformReplay
from agents_tpu.train import FusedTrainLoop as JaxFusedTrainLoop
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu.utils import common as jcommon
from agents_tpu_torch import metrics
from agents_tpu_torch.agents.dqn import DqnAgent
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.environments.classic import CartPole
from agents_tpu_torch.networks import make_q_network
from agents_tpu_torch.replay_buffers import UniformReplay
from agents_tpu_torch.train import FusedTrainLoop
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import common, convert, nest_utils
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from test_torch_parity_utils import (assert_close, assert_equal,
                                     jax_collect_draws, jax_eval_reset_draws,
                                     jax_reset_draws, jax_sample_draws,
                                     merge_draws)

torch.set_num_threads(1)

B, CAP, S, FC, LIMIT = 8, 32, 16, (16, 8), 12
INITIAL, ITERS = 8, 5
HP = dict(epsilon_greedy=0.1, gamma=0.99, target_update_tau=0.05,
          target_update_period=2)
FIELDS = ("step_type", "observation", "action", "next_step_type", "reward",
          "discount")


def _jax_loop():
  env = BatchedJaxEnv(JaxCartPole(max_episode_steps=LIMIT), batch_size=B)
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = jnetworks.make_q_network(tss.observation, asp, fc_layer_params=FC)
  agent = JaxDqnAgent(tss, asp, qnet, optax.adam(1e-3),
                      td_errors_loss_fn=jcommon.element_wise_squared_loss,
                      **HP)
  replay = JaxUniformReplay(jtj.trajectory_spec(tss, asp), B, CAP)
  return JaxFusedTrainLoop(env, agent, replay,
                           metrics=jmetrics.standard_collect_metrics(5),
                           sample_batch_size=S)


def _torch_loop(q_params=None, seed=0):
  env = BatchedTorchEnv(CartPole(max_episode_steps=LIMIT), B, device="cpu")
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = make_q_network(tss.observation, asp, fc_layer_params=FC,
                        device="cpu",
                        generator=torch.Generator().manual_seed(seed))
  if q_params is not None:
    qnet.load_state_dict(convert.q_params_to_state_dict(q_params))
  agent = DqnAgent(tss, asp, qnet, lambda p: torch.optim.Adam(p, lr=1e-3),
                   td_errors_loss_fn=common.element_wise_squared_loss,
                   device="cpu", **HP)
  replay = UniformReplay(ttj.trajectory_spec(tss, asp), B, CAP, device="cpu")
  return FusedTrainLoop(env, agent, replay,
                        metrics=metrics.standard_collect_metrics(5),
                        sample_batch_size=S, device="cpu")


def _jax_loop_draws(key, asp):
  """Every draw of `init(key, INITIAL)` then ITERS iterations, per site."""
  _, k_driver, k_collect, k_loop = jax.random.split(key, 4)
  records = [{"env_reset": [jax_reset_draws(k_driver, B)]},
             jax_collect_draws(k_collect, INITIAL, B, asp)]
  k = k_loop
  for i in range(ITERS):
    k, k_c, k_s = jax.random.split(k, 3)
    count = INITIAL + i + 1
    num_valid = min(count, CAP) - 2 + 1
    records.append(jax_collect_draws(k_c, 1, B, asp))
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
  q0 = jax.device_get(q0)

  tloop = _torch_loop(q0)
  draws = ReplayDraws(_jax_loop_draws(key, jloop.env.action_spec()))
  tstate = tloop.init(draws=draws, initial_collect_steps=INITIAL)
  tstate, tlosses = tloop.run(tstate, ITERS)
  return (jloop, jstate, jlosses), (tloop, tstate, tlosses), draws


def test_fused_iterations_match_jax(runs):
  (jloop, jstate, jlosses), (tloop, tstate, tlosses), draws = runs
  assert all(v == 0 for v in draws.remaining().values())
  assert tuple(tlosses.shape) == (ITERS,)
  assert_close(tlosses, jlosses)

  # Replay ring: every field, and the count.
  assert tstate.replay_state.count == int(jstate.replay_state.count) == (
      INITIAL + ITERS)
  for f in FIELDS:
    a = getattr(tstate.replay_state.storage, f)
    b = getattr(jstate.replay_state.storage, f)
    if a.dtype.is_floating_point:
      assert_close(a, b, err_msg=f)
    else:
      assert_equal(a, b, f)
  # Episodes ended inside the window, so step types were exercised.
  assert (tstate.replay_state.storage.next_step_type == 2).any()

  # Online and target params, and the train step.
  ja = jax.device_get(jstate.agent_state)
  for tree, net in ((ja.q_params, tstate.agent_state.q_network),
                    (ja.target_q_params, tstate.agent_state.target_q_network)):
    expect = convert.q_params_to_state_dict(tree)
    for k, v in net.state_dict().items():
      assert_close(v, expect[k], err_msg=k)
  assert tstate.agent_state.train_step == int(ja.train_step) == ITERS

  # Collect metrics.
  jres, tres = jloop.results(jstate), tloop.results(tstate)
  assert set(jres) == set(tres)
  for k in jres:
    assert_close(tres[k], jres[k], err_msg=k)

  # The driver's current time step.
  tts_, jts_ = tstate.driver_state.time_step, jstate.driver_state.time_step
  assert_equal(tts_.step_type, jts_.step_type)
  assert_close(tts_.observation, jts_.observation)


@pytest.mark.parametrize("num_episodes", [8, 11])
def test_evaluate_matches_jax_and_counts_exactly(runs, num_episodes):
  """Greedy eval: exactly `num_episodes` episodes on both sides, with the
  same returns. The port checks its quotas every 32 steps; the masked
  overshoot frames leave the metrics alone."""
  (jloop, jstate, _), (tloop, tstate, _), _ = runs
  max_steps = 64
  key = jax.random.key(11)
  jout = jloop.evaluate(jstate, key, num_episodes=num_episodes,
                        max_steps=max_steps)
  k_init, k_run = jax.random.split(key)
  draws = ReplayDraws({"env_reset": [jax_reset_draws(k_init, B)]
                       + jax_eval_reset_draws(k_run, B, max_steps)})
  tout = tloop.evaluate(tstate, draws, num_episodes=num_episodes,
                        max_steps=max_steps)
  assert int(tout["NumberOfEpisodes"]) == int(jout["NumberOfEpisodes"]) == (
      num_episodes)
  for k in ("AverageReturn", "AverageEpisodeLength"):
    assert_close(tout[k], jout[k], err_msg=k)


def test_evaluate_warns_when_max_steps_runs_out(runs):
  _, (tloop, tstate, _), _ = runs
  with pytest.warns(UserWarning, match="max_steps"):
    out = tloop.evaluate(tstate, Draws(0, "cpu"), num_episodes=16,
                         max_steps=3)
  assert int(out["NumberOfEpisodes"]) == 0


def test_run_with_info_and_generator_draws():
  """A seeded run twice gives the same result; the stacked LossInfo keeps
  the per-iteration extras."""
  outs = []
  for _ in range(2):
    loop = _torch_loop(seed=3)
    state = loop.init(seed=5, initial_collect_steps=4)
    state, infos = loop.run_with_info(state, 3)
    outs.append((infos, loop.results(state), state))
  (a, ra, sa), (b, rb, _) = outs
  assert tuple(a.loss.shape) == (3,)
  assert tuple(a.extra.td_error.shape) == (3, S)
  assert_equal(a.loss, b.loss)
  for k in ra:
    assert_equal(ra[k], rb[k])
  assert sa.replay_state.count == 4 + 3
  # Every tensor of the state lives on the loop's device.
  leaves = nest_utils.flatten((sa.driver_state, sa.replay_state.storage,
                               sa.metric_states))
  assert all(x.device.type == "cpu" for x in leaves
             if isinstance(x, torch.Tensor))


def test_loop_refuses_parts_on_another_device():
  loop = _torch_loop()

  class Elsewhere:
    device = torch.device("meta")

  with pytest.raises(ValueError, match="lives on"):
    FusedTrainLoop(Elsewhere(), loop.agent, loop.replay, device="cpu")
  with warnings.catch_warnings():
    warnings.simplefilter("error")
    loop.init(seed=0)
