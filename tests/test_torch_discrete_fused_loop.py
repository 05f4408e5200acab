"""The discrete-action slice as a whole: `FusedTrainLoop` with `DqnAgent`
collecting by `BoltzmannPolicy` on the device Acrobot against the JAX
package's loop, and the same loop on MountainCar.

Both loops start from the same Q network (the JAX side's flax init, carried
across by `convert`) and the same draws: the Acrobot resets, the Boltzmann
samples' Gumbel uniforms (site "categorical") and the replay samples are
re-derived from the JAX loop's own key splits and replayed into the port.
Episodes are cut to 10 steps, so the run crosses auto-resets and the ring
of 64 wraps. After the initial collect and 5 fused iterations of 2 train
steps, losses, the Q networks, Adam's moments, the replay ring and the
collect metrics agree to rtol 1e-5 / atol 1e-5 (an ulp of RK4's `sin`
grows over an episode of Acrobot's swing); actions and step types exactly.
"""
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from agents_tpu import metrics as jmetrics
from agents_tpu import networks as jnetworks
from agents_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from agents_tpu.environments.classic.acrobot import Acrobot as JaxAcrobot
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu.replay_buffers import UniformReplay as JaxUniformReplay
from agents_tpu.train import FusedTrainLoop as JaxFusedTrainLoop
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch import metrics
from agents_tpu_torch.agents.dqn import DqnAgent
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.environments.classic import Acrobot, MountainCar
from agents_tpu_torch.networks import make_q_network
from agents_tpu_torch.policies import BoltzmannPolicy
from agents_tpu_torch.replay_buffers import UniformReplay
from agents_tpu_torch.train import FusedTrainLoop
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.trajectories.time_step import StepType
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import (assert_close, assert_equal,
                                     jax_collect_draws, jax_env_reset_draws,
                                     jax_sample_draws, merge_draws)

torch.set_num_threads(1)

B, CAP, S, TRAIN_STEPS, INITIAL, ITERS = 4, 64, 16, 2, 32, 5
EPISODE, FC, TEMPERATURE = 10, (16,), 0.5
RTOL = ATOL = 1e-5
FIELDS = ("step_type", "observation", "action", "next_step_type", "reward",
          "discount")


def _boltzmann_draws(k_pol, batch_size, action_spec):
  """`Policy._action`'s sample of one categorical leaf (policy.py:94-97):
  ``jax.random.categorical`` from ``split(k_pol, 1)[0]``, its Gumbel
  uniforms over ``[B, K]``."""
  k = int(action_spec.maximum) - int(action_spec.minimum) + 1
  return {"categorical": jax.random.uniform(
      jax.random.split(k_pol, 1)[0], (batch_size, k), jnp.float32,
      minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)}


def _jax_loop():
  env = BatchedJaxEnv(JaxAcrobot(EPISODE), batch_size=B)
  tss, asp = env.time_step_spec(), env.action_spec()
  agent = JaxDqnAgent(tss, asp, jnetworks.make_q_network(
      tss.observation, asp, fc_layer_params=FC), optax.adam(1e-3),
                      boltzmann_temperature=TEMPERATURE, gamma=0.99,
                      target_update_tau=0.05, target_update_period=2)
  replay = JaxUniformReplay(jtj.trajectory_spec(tss, asp), B, CAP)
  return JaxFusedTrainLoop(env, agent, replay,
                           metrics=jmetrics.standard_collect_metrics(5),
                           sample_batch_size=S,
                           train_steps_per_iteration=TRAIN_STEPS)


def _torch_loop(env_cls=Acrobot):
  env = BatchedTorchEnv(env_cls(EPISODE), B, device="cpu")
  tss, asp = env.time_step_spec(), env.action_spec()
  agent = DqnAgent(tss, asp, make_q_network(tss.observation, asp,
                                            fc_layer_params=FC, device="cpu"),
                   lambda p: torch.optim.Adam(p, lr=1e-3),
                   boltzmann_temperature=TEMPERATURE, gamma=0.99,
                   target_update_tau=0.05, target_update_period=2,
                   device="cpu")
  replay = UniformReplay(ttj.trajectory_spec(tss, asp), B, CAP, device="cpu")
  return FusedTrainLoop(env, agent, replay,
                        metrics=metrics.standard_collect_metrics(5),
                        sample_batch_size=S,
                        train_steps_per_iteration=TRAIN_STEPS, device="cpu")


def _jax_loop_draws(key, jloop):
  env, asp = jloop.env.env, jloop.env.action_spec()
  _, k_driver, k_collect, k_loop = jax.random.split(key, 4)
  records = [jax_env_reset_draws(k_driver, B, env),
             jax_collect_draws(k_collect, INITIAL, B, asp, env,
                               _boltzmann_draws)]
  k = k_loop
  for i in range(ITERS):
    k, k_c, k_s = jax.random.split(k, 3)
    num_valid = min(INITIAL + i + 1, CAP) - 2 + 1
    records.append(jax_collect_draws(k_c, 1, B, asp, env, _boltzmann_draws))
    for k_sample in jax.random.split(k_s, TRAIN_STEPS):
      records.append(jax_sample_draws(k_sample, S, num_valid, B))
  return merge_draws(*records)


@pytest.fixture(scope="module")
def runs():
  jloop = _jax_loop()
  key = jax.random.key(4)

  def init_and_run(k):
    state = jloop.init(k, initial_collect_steps=INITIAL)
    return state.agent_state, jloop.run(state, ITERS)

  jagent0, (jstate, jlosses) = jax.jit(init_and_run)(key)
  tloop = _torch_loop()
  tloop.agent.q_network.load_state_dict(convert.q_params_to_state_dict(
      jax.device_get(jagent0.q_params)))
  draws = ReplayDraws(_jax_loop_draws(key, jloop))
  tstate = tloop.init(draws=draws, initial_collect_steps=INITIAL)
  tstate, tlosses = tloop.run(tstate, ITERS)
  return (jloop, jstate, jlosses), (tloop, tstate, tlosses), draws


def test_boltzmann_dqn_on_acrobot_matches_jax(runs):
  (jloop, jstate, jlosses), (tloop, tstate, tlosses), draws = runs
  assert isinstance(tloop.agent.collect_policy, BoltzmannPolicy)
  assert all(v == 0 for v in draws.remaining().values())
  assert_close(tlosses, jlosses, RTOL, ATOL)
  storage = tstate.replay_state.storage
  assert tstate.replay_state.count == int(jstate.replay_state.count)
  for f in FIELDS:
    a, b = getattr(storage, f), getattr(jstate.replay_state.storage, f)
    if a.dtype.is_floating_point:
      assert_close(a, b, RTOL, ATOL, f)
    else:
      assert_equal(a, b, f)
  assert (storage.step_type == StepType.FIRST).any()
  assert len(set(storage.action.flatten().tolist())) == 3
  host = jax.device_get(jstate.agent_state)
  for tag, tree, net in (("q", host.q_params, tstate.agent_state.q_network),
                         ("target", host.target_q_params,
                          tstate.agent_state.target_q_network)):
    expect = convert.q_params_to_state_dict(tree)
    for k, v in net.state_dict().items():
      assert_close(v, expect[k], RTOL, ATOL, f"{tag}.{k}")
  adam = host.opt_state[0]
  mu = list(convert.q_params_to_state_dict(adam.mu).values())
  for p, m in zip(tstate.agent_state.q_network.parameters(), mu):
    st = tstate.agent_state.optimizer.state[p]
    assert_close(st["exp_avg"], m, RTOL, ATOL)
    assert float(st["step"]) == float(adam.count) == ITERS * TRAIN_STEPS
  jres, tres = jloop.results(jstate), tloop.results(tstate)
  for k in jres:
    assert_close(tres[k], jres[k], RTOL, ATOL, k)


def test_boltzmann_dqn_on_mountain_car_runs():
  """The same loop on MountainCar from the port's own draws: finite losses
  and every action taken."""
  loop = _torch_loop(MountainCar)
  state = loop.init(seed=0, initial_collect_steps=INITIAL)
  state, losses = loop.run(state, ITERS)
  assert bool(torch.isfinite(losses).all())
  assert state.agent_state.train_step == ITERS * TRAIN_STEPS
  actions = state.replay_state.storage.action[:INITIAL + ITERS]
  assert set(actions.flatten().tolist()) == {0, 1, 2}
