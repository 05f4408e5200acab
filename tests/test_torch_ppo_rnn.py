"""Port parity: PPO with recurrent (LSTM) actor and value networks against the
JAX package.

  - the four tests of `tests/test_ppo_rnn.py`, on the port (the learning
    smoke through `examples/ppo_cartpole_torch.py --preset=rnn_learn`, the
    JAX test's config);
  - one train step on ``[B, T]`` sequences from a whole JAX agent state
    carried across by `convert`, the port replaying the JAX permutations
    of the sequence axis, for the plain clip agent and the adaptive-KL
    one: losses, extras, both networks, the Adam moments, the
    normalizers and beta (rtol 1e-5 / atol 1e-6, second moments atol
    1e-9);
  - the example's recurrent on-policy loop against the JAX loop for two
    iterations with every draw replayed: the second rollout starts from
    the LSTM carry the first left in the driver.
"""
import dataclasses
import math

import jax
import numpy as np
import optax
import pytest
import torch

from agents_tpu import metrics as jmetrics
from agents_tpu import networks as jnetworks
from agents_tpu.agents.ppo import PPOAgent as JaxPPOAgent
from agents_tpu.agents.ppo import PPOKLPenaltyAgent as JaxPPOKLPenaltyAgent
from agents_tpu.environments.classic.cartpole import CartPole as JaxCartPole
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu.specs import array_spec as jspec
from agents_tpu.train import OnPolicyTrainLoop as JaxOnPolicyTrainLoop
from agents_tpu.trajectories import time_step as jts
from agents_tpu_torch import networks
from agents_tpu_torch.agents.ppo import PPOAgent, PPOKLPenaltyAgent
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import convert, nest_utils
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from examples.ppo_cartpole_torch import (RNN_LEARN, Config, build_loop,
                                         parse_ppo_args)
from test_torch_parity_utils import (assert_close, assert_equal,
                                     jax_collect_draws, jax_env_reset_draws,
                                     merge_draws)
from test_torch_ppo_agent import (B, T, _adam_close, experience,
                                  jax_permutations, to_jax, to_torch)

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
OBS = tspec.ArraySpec((4,), np.float32)
ACT = tspec.BoundedArraySpec((), np.int32, 0, 1)
RNN = dict(input_fc_layer_params=(8,), lstm_size=8,
           output_fc_layer_params=(8,))


def _ppo_rnn(cls=PPOAgent, **kw):
  kw.setdefault("num_epochs", 2)
  kw.setdefault("num_minibatches", 2)
  return cls(ts.time_step_spec(OBS), ACT,
             lambda p: torch.optim.Adam(p, lr=1e-3),
             networks.make_actor_distribution_rnn_network(OBS, ACT, **RNN,
                                                          device="cpu"),
             networks.make_value_rnn_network(OBS, **RNN, device="cpu"),
             device="cpu", **kw)


def _rollout(agent, b=4, t=8):
  """[B, T] experience of the agent's loop on CartPole cut to 6 steps."""
  loop = build_loop(Config(env_batch_size=b, rollout_length=t,
                           max_episode_steps=6, device="cpu"))
  loop.agent = agent
  loop.driver.policy = agent.collect_policy
  state = dataclasses.replace(loop.init(0), agent_state=agent.init())
  return loop.collect(state)


# -- the four tests of tests/test_ppo_rnn.py -----------------------------------


def test_ppo_rnn_agent_is_recurrent_and_policy_carries_state():
  agent = _ppo_rnn()
  assert agent._recurrent
  actor_state, value_state = pstate = agent.collect_policy.init_state(3)
  assert actor_state[0].shape == (3, 8)
  state = agent.init()
  step = ts.restart(torch.zeros(3, 4), batch_size=3)
  out = agent.collect_policy.action(agent.policy_params(state), step, pstate,
                                    Draws(1, "cpu"))
  new_actor_state, new_value_state = out.state
  assert new_actor_state[0].shape == (3, 8)
  assert new_value_state[0].shape == (3, 8)
  assert out.info["value_prediction"].shape == (3,)


def test_ppo_rnn_sequence_train_runs_and_updates():
  agent = _ppo_rnn(num_epochs=3, num_minibatches=2)
  state, experience_ = _rollout(agent)
  assert experience_.step_type.shape == (4, 8)
  before = next(agent.actor_network.parameters()).detach().clone()
  _, info = agent.train(state.agent_state, experience_, draws=state.draws)
  assert np.isfinite(float(info.loss))
  assert not torch.allclose(before, next(agent.actor_network.parameters()))


def test_ppo_rnn_minibatches_partition_sequences_not_frames():
  """2 minibatches split the 4 sequences into [2, T - 1] blocks with time
  whole; 3 do not divide 4 sequences and raise."""
  agent = _ppo_rnn(num_epochs=1, num_minibatches=2)
  state, exp = _rollout(agent)
  seen = []
  loss_fn = agent._loss
  agent._loss = lambda s, mb: seen.append(tuple(mb[1].shape)) or loss_fn(
      s, mb)
  _, info = agent.train(state.agent_state, exp, draws=state.draws)
  assert np.isfinite(float(info.loss))
  assert seen == [(2, 7), (2, 7)]
  with pytest.raises(ValueError, match="4 sequences"):
    _ppo_rnn(num_epochs=1, num_minibatches=3).train(
        state.agent_state, exp, draws=state.draws)


def test_ppo_rnn_loop_learns_cartpole_smoke():
  """The JAX test's config (B=8, T=48, (32,) / 16 / (32,), 4 epochs x 2
  minibatches, entropy 0.01, Adam 1e-3) over 30 iterations."""
  cfg = parse_ppo_args(["--preset=rnn_learn", "--device=cpu"])
  assert {k: getattr(cfg, k) for k in RNN_LEARN} == RNN_LEARN
  loop = build_loop(cfg)
  state = loop.init(cfg.seed)
  state, losses = loop.run(state, cfg.num_iterations)
  ret = float(loop.results(state)["AverageReturn"])
  assert torch.isfinite(losses).all()
  assert ret > 35.0, f"PPO-RNN did not improve over random (~20): {ret}"


# -- one train step against the JAX agent --------------------------------------

VARIANTS = {"plain": (JaxPPOAgent, PPOAgent, {"entropy_regularization": 0.01}),
            "adaptive_kl": (JaxPPOKLPenaltyAgent, PPOKLPenaltyAgent, {})}
TO_SD = (convert.actor_rnn_params_to_state_dict,
         convert.value_rnn_params_to_state_dict)


def _agents(variant):
  jcls, tcls, kw = VARIANTS[variant]
  kw = dict(num_epochs=2, num_minibatches=2, **kw)
  jobs = jspec.ArraySpec((4,), np.float32)
  jact = jspec.BoundedArraySpec((), np.int32, 0, 1)
  jagent = jcls(jts.time_step_spec(jobs), jact, optax.adam(1e-3),
                jnetworks.make_actor_distribution_rnn_network(jobs, jact,
                                                              **RNN),
                jnetworks.make_value_rnn_network(jobs, **RNN), **kw)
  return jagent, _ppo_rnn(tcls, **kw)


def _assert_states_close(jstate, tstate, msg):
  expect = convert.ppo_agent_state_to_torch(jax.device_get(jstate), *TO_SD)
  for field in ("actor_network", "value_network"):
    for k, v in getattr(tstate, field).state_dict().items():
      assert_close(v, expect[field][k], RTOL, ATOL, f"{msg} {field}.{k}")
  _adam_close(tstate.optimizer, expect["adam"], msg)
  for field in ("obs_norm_state", "reward_norm_state"):
    for name in ("count", "mean_sum", "var_sum"):
      assert_close(getattr(getattr(tstate, field), name),
                   getattr(expect[field], name), RTOL, ATOL,
                   f"{msg} {field}.{name}")
  assert_close(tstate.kl_beta, expect["kl_beta"], RTOL, 0, f"{msg} beta")
  assert tstate.train_step == expect["train_step"]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sequence_train_step_matches_jax(variant):
  jagent, tagent = _agents(variant)
  jtrain = jax.jit(jagent.train)
  e1, e2 = experience(0, True), experience(1, True)
  jstate, _ = jtrain(jagent.init(jax.random.key(0)), to_jax(e1),
                     key=jax.random.key(1))
  tstate = convert.load_ppo_agent_state(
      tagent.init(),
      convert.ppo_agent_state_to_torch(jax.device_get(jstate), *TO_SD))
  _assert_states_close(jstate, tstate, "converted")
  k2 = jax.random.key(2)
  jstate2, jinfo = jtrain(jstate, to_jax(e2), key=k2)
  # The permutations run over the B sequences, not the B * (T - 1) frames.
  draws = ReplayDraws(jax_permutations(k2, 2, B))
  tstate2, tinfo = tagent.train(tstate, to_torch(e2), draws=draws)
  assert all(v == 0 for v in draws.remaining().values())
  assert_close(tinfo.loss, jinfo.loss, RTOL, ATOL, "loss")
  for f in dataclasses.fields(tinfo.extra):
    assert_close(getattr(tinfo.extra, f.name), getattr(jinfo.extra, f.name),
                 RTOL, ATOL, f.name)
  _assert_states_close(jstate2, tstate2, "trained")
  if variant == "adaptive_kl":
    assert float(tstate2.kl_beta) != float(tstate.kl_beta)


# -- the recurrent loop: the carry across two collects -------------------------

LB, LT, EPISODE, ITERS = 4, 16, 8, 2


def _loop_config():
  return Config(max_episode_steps=EPISODE, env_batch_size=LB,
                rollout_length=LT, num_iterations=ITERS, num_epochs=2,
                num_minibatches=2, learning_rate=3e-3, lstm_size=8,
                actor_fc_layers=(8,), value_fc_layers=(8,),
                lstm_output_fc_layers=(8,), return_buffer=5, device="cpu")


def _jax_loop(cfg):
  env = BatchedJaxEnv(JaxCartPole(max_episode_steps=EPISODE), batch_size=LB)
  tss, asp = env.time_step_spec(), env.action_spec()
  agent = JaxPPOAgent(
      tss, asp, optax.adam(cfg.learning_rate),
      jnetworks.make_actor_distribution_rnn_network(tss.observation, asp,
                                                    **RNN),
      jnetworks.make_value_rnn_network(tss.observation, **RNN),
      num_epochs=cfg.num_epochs, num_minibatches=cfg.num_minibatches,
      entropy_regularization=cfg.entropy_regularization)
  return JaxOnPolicyTrainLoop(env, agent, jmetrics.standard_collect_metrics(5),
                              rollout_length=LT)


def test_recurrent_loop_matches_jax_and_carries_the_lstm_state():
  cfg = _loop_config()
  jloop = _jax_loop(cfg)
  key = jax.random.key(5)
  jstate0 = jax.jit(jloop.init)(key)
  jstate, jlosses = jax.jit(lambda s: jloop.run(s, ITERS))(jstate0)
  params0 = jax.device_get(jstate0.agent_state)

  env, asp = jloop.env.env, jloop.env.action_spec()
  _, k_driver, k = jax.random.split(key, 3)
  records = [jax_env_reset_draws(k_driver, LB, env)]
  for _ in range(ITERS):
    k, k_collect, k_train = jax.random.split(k, 3)
    records.append(jax_collect_draws(k_collect, LT, LB, asp, env, "ppo"))
    records.append(jax_permutations(k_train, cfg.num_epochs, LB))
  draws = ReplayDraws(merge_draws(*records))

  tloop = build_loop(cfg)
  tloop.agent.actor_network.load_state_dict(
      convert.actor_rnn_params_to_state_dict(params0.actor_params))
  tloop.agent.value_network.load_state_dict(
      convert.value_rnn_params_to_state_dict(params0.value_params))
  tstate = tloop.init(draws=draws)
  tstate, tlosses = tloop.run(tstate, ITERS)
  assert all(v == 0 for v in draws.remaining().values())
  assert_close(tlosses, jlosses, RTOL, ATOL, "losses")
  _assert_states_close(jstate.agent_state, tstate.agent_state, "loop")
  jres, tres = jloop.results(jstate), tloop.results(tstate)
  for name in jres:
    assert_close(tres[name], jres[name], RTOL, ATOL, name)
  # Both rollouts crossed episode ends, and the carry the driver holds
  # after the second (actor's, then value's (c, h)) is the JAX driver's.
  jcarry = nest_utils.flatten(jax.device_get(jstate.driver_state.policy_state))
  tcarry = nest_utils.flatten(tstate.driver_state.policy_state)
  assert len(tcarry) == len(jcarry) == 4
  for a, b in zip(tcarry, jcarry):
    assert tuple(a.shape) == (LB, 8)
    assert float(a.abs().max()) > 0
    assert_close(a, b, RTOL, ATOL, "carry")
  assert_equal(tstate.driver_state.time_step.step_type,
               jstate.driver_state.time_step.step_type)
  assert math.isfinite(float(tlosses[-1]))
