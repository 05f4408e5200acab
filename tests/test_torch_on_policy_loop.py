"""The on-policy slice as a whole: `agents_tpu_torch.train.
OnPolicyTrainLoop` with PPO (the example's construction) against the JAX
package's `OnPolicyTrainLoop`, on CartPole (a categorical head) and on the
device Pendulum (the schulman17 preset's tanh nets, `NormalProjection`
head, Adam eps 1e-5 with a linear decay, gradient clipping 0.5); greedy
evaluation over exactly 6 episodes; and learning on CartPole.

Both loops start from the same actor and value networks (the JAX side's
flax init, carried across by `convert`) and the same draws: the env
resets, the policy's Gumbel uniforms or normals, and each epoch's
permutation are re-derived from the JAX loop's own key splits and
replayed into the port. Episodes are cut to 8 steps, so rollouts of 16
steps cross auto-resets and boundary frames. After 3 iterations the
losses, both networks, the Adam moments (the second moments to atol
1e-9), the normalizers and the collect metrics agree to float32 rtol 1e-5
/ atol 1e-6.
"""
import dataclasses
import functools
import math

import flax.linen as fnn
import jax
import numpy as np
import optax
import pytest
import torch

from agents_tpu import metrics as jmetrics
from agents_tpu import networks as jnetworks
from agents_tpu.agents.ppo import PPOClipAgent as JaxPPOClipAgent
from agents_tpu.environments.classic.cartpole import CartPole as JaxCartPole
from agents_tpu.environments.classic.pendulum import Pendulum as JaxPendulum
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu.eval import metric_utils as jmetric_utils
from agents_tpu.networks.projection_networks import \
    NormalProjection as JaxNormalProjection
from agents_tpu.train import OnPolicyTrainLoop as JaxOnPolicyTrainLoop
from agents_tpu_torch.eval import metric_utils
from agents_tpu_torch.trajectories.time_step import StepType
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import ReplayDraws
from examples.ppo_cartpole_torch import (SCHULMAN17_PENDULUM, Config,
                                         build_env, build_loop)
from test_torch_parity_utils import (assert_close, jax_collect_draws,
                                     jax_env_reset_draws, jax_eval_draws,
                                     merge_draws)
from test_torch_ppo_agent import _adam_close, jax_permutations

torch.set_num_threads(1)

B, T, EPOCHS, MINIBATCHES, ITERS, EPISODE, FC = 4, 16, 2, 2, 3, 8, (16,)
RTOL, ATOL = 1e-5, 1e-6


def _config(env):
  fields = dict(env=env, max_episode_steps=EPISODE, env_batch_size=B,
                rollout_length=T, num_iterations=ITERS, num_epochs=EPOCHS,
                num_minibatches=MINIBATCHES, learning_rate=3e-3,
                actor_fc_layers=FC, value_fc_layers=FC, return_buffer=5,
                num_eval_envs=B, device="cpu")
  if env == "pendulum":
    preset = {k: v for k, v in SCHULMAN17_PENDULUM.items()
              if k not in fields and k not in ("num_iterations",
                                                "log_interval")}
    fields.update(preset, learning_rate=3e-3)
  return Config(**fields)


def _jax_loop(cfg):
  env = BatchedJaxEnv((JaxCartPole if cfg.env == "cartpole" else
                       JaxPendulum)(max_episode_steps=EPISODE),
                      batch_size=B)
  tss, asp = env.time_step_spec(), env.action_spec()
  activation = {"relu": fnn.relu, "tanh": fnn.tanh}[cfg.activation]
  proj = JaxNormalProjection
  if cfg.initial_std > 0:
    proj = functools.partial(JaxNormalProjection,
                             std_bias_initializer_value=math.log(
                                 math.exp(cfg.initial_std) - 1.0))
  lr = cfg.learning_rate
  if cfg.lr_decay:
    lr = optax.linear_schedule(lr, 0.0, cfg.num_iterations * cfg.num_epochs
                               * cfg.num_minibatches)
  agent = JaxPPOClipAgent(
      tss, asp, optax.adam(lr, eps=cfg.adam_eps),
      jnetworks.make_actor_distribution_network(
          tss.observation, asp, fc_layer_params=FC, activation=activation,
          continuous_projection=proj),
      jnetworks.make_value_network(tss.observation, fc_layer_params=FC,
                                   activation=activation),
      discount_factor=cfg.discount_factor, lambda_value=cfg.lambda_value,
      num_epochs=EPOCHS, num_minibatches=MINIBATCHES,
      entropy_regularization=cfg.entropy_regularization,
      gradient_clipping=cfg.gradient_clipping or None)
  return JaxOnPolicyTrainLoop(env, agent, jmetrics.standard_collect_metrics(5),
                              rollout_length=T)


def _jax_loop_draws(key, jloop):
  """Every draw of `init(key)` then ITERS iterations, per site
  (on_policy_loop.py:46-72, ppo_agent.py:416)."""
  env, asp = jloop.env.env, jloop.env.action_spec()
  _, k_driver, k = jax.random.split(key, 3)
  records = [jax_env_reset_draws(k_driver, B, env)]
  for _ in range(ITERS):
    k, k_collect, k_train = jax.random.split(k, 3)
    records.append(jax_collect_draws(k_collect, T, B, asp, env, "ppo"))
    records.append(jax_permutations(k_train, EPOCHS, B * (T - 1)))
  return merge_draws(*records)


@pytest.fixture(scope="module", params=["cartpole", "pendulum"])
def runs(request):
  cfg = _config(request.param)
  jloop = _jax_loop(cfg)
  key = jax.random.key(7)
  jstate0 = jax.jit(jloop.init)(key)
  jstate, jlosses = jax.jit(lambda s: jloop.run(s, ITERS))(jstate0)
  params0 = jax.device_get(jstate0.agent_state)

  tloop = build_loop(cfg)
  tloop.agent.actor_network.load_state_dict(
      convert.actor_params_to_state_dict(params0.actor_params))
  tloop.agent.value_network.load_state_dict(
      convert.value_params_to_state_dict(params0.value_params))
  draws = ReplayDraws(_jax_loop_draws(key, jloop))
  tstate = tloop.init(draws=draws)
  tstate, tlosses = tloop.run(tstate, ITERS)
  return cfg, (jloop, jstate, jlosses), (tloop, tstate, tlosses), draws


def test_on_policy_iterations_match_jax(runs):
  cfg, (jloop, jstate, jlosses), (tloop, tstate, tlosses), draws = runs
  assert all(v == 0 for v in draws.remaining().values())
  assert tuple(tlosses.shape) == (ITERS,)
  assert_close(tlosses, jlosses, RTOL, ATOL, "losses")

  expect = convert.ppo_agent_state_to_torch(
      jax.device_get(jstate.agent_state))
  ts = tstate.agent_state
  for field in ("actor_network", "value_network"):
    for k, v in getattr(ts, field).state_dict().items():
      assert_close(v, expect[field][k], RTOL, ATOL, f"{field}.{k}")
  _adam_close(ts.optimizer, expect["adam"], "loop")
  for field in ("obs_norm_state", "reward_norm_state"):
    for name in ("count", "mean_sum", "var_sum"):
      assert_close(getattr(getattr(ts, field), name),
                   getattr(expect[field], name), RTOL, ATOL, name)
  assert ts.train_step == expect["train_step"] == ITERS
  if cfg.lr_decay:
    assert ts.lr_scheduler.last_epoch == expect["schedule_count"] == (
        ITERS * EPOCHS * MINIBATCHES)

  jres, tres = jloop.results(jstate), tloop.results(tstate)
  assert set(jres) == set(tres)
  for k in jres:
    assert_close(tres[k], jres[k], RTOL, ATOL, k)
  assert int(tres["NumberOfEpisodes"]) >= B
  assert_close(tstate.driver_state.time_step.observation,
               jstate.driver_state.time_step.observation, RTOL, ATOL)


def test_greedy_eval_matches_jax(runs):
  """Greedy eval over exactly 6 episodes of at most 8 steps on both
  sides."""
  cfg, (jloop, jstate, _), (tloop, tstate, _), _ = runs
  max_steps, key = 32, jax.random.key(11)
  jagent = jloop.agent
  jout = jmetric_utils.evaluate_jax_env_episodes(
      jloop.env, jagent.policy, jagent.policy_params(jstate.agent_state), key,
      num_episodes=6, max_steps=max_steps)
  env = jloop.env.env
  k_init, k_run = jax.random.split(key)
  draws = ReplayDraws(merge_draws(jax_env_reset_draws(k_init, B, env),
                                  jax_eval_draws(k_run, B, max_steps, env)))
  tout = metric_utils.evaluate_torch_env_episodes(
      build_env(cfg, B), tloop.agent.policy,
      tloop.agent.policy_params(tstate.agent_state), draws, num_episodes=6,
      max_steps=max_steps)
  assert int(tout["NumberOfEpisodes"]) == int(jout["NumberOfEpisodes"]) == 6
  assert tout["_episodes_completed"] == jout["_episodes_completed"] == 6
  for k in ("AverageReturn", "AverageEpisodeLength", "EnvironmentSteps"):
    assert_close(tout[k], jout[k], RTOL, ATOL, k)


def test_rollout_is_batch_major_with_collect_time_distributions():
  """One `collect`: the experience is [B, T], carries the collect-time
  distribution and value predictions, and its step types chain."""
  loop = build_loop(_config("cartpole"))
  state, exp = loop.collect(loop.init(seed=1))
  assert tuple(exp.step_type.shape) == (B, T)
  assert tuple(exp.policy_info["dist"].logits.shape) == (B, T, 2)
  assert tuple(exp.policy_info["value_prediction"].shape) == (B, T)
  assert bool((exp.next_step_type[:, :-1] == exp.step_type[:, 1:]).all())
  assert bool(((exp.step_type == StepType.LAST)
               == (exp.next_step_type == StepType.FIRST)).all())
  assert bool((state.driver_state.time_step.step_type
               == exp.next_step_type[:, -1]).all())


def test_ppo_loop_learns_cartpole_smoke():
  """The bar of `test_on_policy_agents.py:93-112`: B=8, (32, 32), 4 epochs
  x 2 minibatches, T=64, 40 iterations beat a last-20 return of 40
  (random play scores about 20)."""
  cfg = Config(env_batch_size=8, rollout_length=64, num_epochs=4,
               num_minibatches=2, actor_fc_layers=(32, 32),
               value_fc_layers=(32, 32), device="cpu")
  loop = build_loop(cfg)
  state = loop.init(seed=0)
  state, losses = loop.run(state, 40)
  assert bool(torch.isfinite(losses).all())
  ret = float(loop.results(state)["AverageReturn"])
  assert ret > 40.0, ret
