"""Port parity: recurrent DQN and DDQN (`DqnAgent._sequence_loss`,
`_seq_next_best_q`) against the JAX package.

  - the four tests of `tests/test_rnn_dqn.py`, on the port;
  - one Adam step on ``[S, T]`` sequences from a whole JAX agent state
    carried across by `convert`, for DQN and DDQN, with and without an
    action-mask splitter: the loss, `td_loss`, `td_error`, the online and
    target parameters and the Adam moments (rtol 1e-5 / atol 1e-6);
  - 3 fused iterations of recurrent DDQN on CartPole against the JAX
    `FusedTrainLoop` with every draw replayed: losses, parameters, the
    replay ring and the LSTM carry the driver holds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agents_tpu import metrics as jmetrics
from agents_tpu import networks as jnetworks
from agents_tpu.agents.dqn import DdqnAgent as JaxDdqnAgent
from agents_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from agents_tpu.environments.classic.cartpole import CartPole as JaxCartPole
from agents_tpu.environments.jax_environment import BatchedJaxEnv
from agents_tpu.replay_buffers import UniformReplay as JaxUniformReplay
from agents_tpu.specs import array_spec as jspec
from agents_tpu.train import FusedTrainLoop as JaxFusedTrainLoop
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu.utils import common as jcommon
from agents_tpu_torch import metrics
from agents_tpu_torch import networks
from agents_tpu_torch.agents.dqn import DdqnAgent, DqnAgent
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.environments.classic import CartPole
from agents_tpu_torch.replay_buffers import UniformReplay
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.train import FusedTrainLoop
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import common, convert
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import (assert_close, assert_equal,
                                     jax_collect_draws, jax_reset_draws,
                                     jax_sample_draws, merge_draws)

torch.set_num_threads(1)

OBS = tspec.ArraySpec((3,), np.float32)
TSS = ts.time_step_spec(OBS)
ACT = tspec.BoundedArraySpec((), np.int32, 0, 1)
RNN = dict(input_fc_layer_params=(8,), lstm_size=8,
           output_fc_layer_params=(8,))


def _adam(p):
  return torch.optim.Adam(p, lr=1e-3)


# -- the four tests of tests/test_rnn_dqn.py -----------------------------------


def test_rnn_dqn_sequence_train():
  qrnn = networks.make_q_rnn_network(OBS, ACT, **RNN, device="cpu")
  agent = DqnAgent(TSS, ACT, qrnn, _adam, gamma=0.9,
                   td_errors_loss_fn=common.element_wise_squared_loss,
                   train_sequence_length=6, device="cpu")
  assert agent.train_sequence_length == 6
  state = agent.init()
  before = next(state.q_network.parameters()).detach().clone()
  b = 3
  exp = tj.Trajectory(
      step_type=torch.tensor([0, 1, 1, 2, 0, 1]).repeat(b, 1),
      observation=torch.randn(b, 6, 3, generator=torch.Generator()
                              .manual_seed(1)),
      action=torch.zeros(b, 6, dtype=torch.int32), policy_info=(),
      next_step_type=torch.tensor([1, 1, 2, 0, 1, 1]).repeat(b, 1),
      reward=torch.ones(b, 6),
      discount=torch.tensor([1., 1., 0., 1., 1., 1.]).repeat(b, 1))
  new_state, info = agent.train(state, exp)
  assert np.isfinite(float(info.loss))
  # The boundary frame (index 3, step type LAST) adds no loss.
  assert_close(info.extra.td_loss[:, 3], np.zeros(b, np.float32))
  assert not torch.allclose(before, next(new_state.q_network.parameters()))


def test_rnn_policy_action_carries_state():
  qrnn = networks.make_q_rnn_network(OBS, ACT, lstm_size=8, device="cpu")
  agent = DqnAgent(TSS, ACT, qrnn, _adam, train_sequence_length=4,
                   device="cpu")
  state = agent.init()
  pol_state = agent.policy.init_state(2)
  step = ts.restart(torch.zeros(2, 3), batch_size=2)
  out = agent.policy.action(agent.policy_params(state), step, pol_state)
  assert out.state[0].shape == (2, 8)


def test_rnn_ddqn_decouples_argmax_from_target_eval():
  """Recurrent DDQN takes the target at the online argmax; DQN the target
  max; a mask removes the candidates it covers."""
  qrnn = networks.make_q_rnn_network(OBS, ACT, input_fc_layer_params=(4,),
                                     lstm_size=4, device="cpu")
  ddqn = DdqnAgent(TSS, ACT, qrnn, _adam, device="cpu")
  dqn = DqnAgent(TSS, ACT, qrnn, _adam, device="cpu")
  online = torch.tensor([[[5.0, 1.0], [5.0, 1.0]]])
  target = torch.tensor([[[2.0, 9.0], [2.0, 9.0]]])
  assert_close(ddqn._seq_next_best_q(online, target, None), [[2.0, 2.0]])
  assert_close(dqn._seq_next_best_q(online, target, None), [[9.0, 9.0]])
  mask = torch.tensor([[[False, True], [False, True]]])
  assert_close(ddqn._seq_next_best_q(online, target, mask), [[9.0, 9.0]])
  assert_close(dqn._seq_next_best_q(online, target, mask), [[9.0, 9.0]])


def test_rnn_dqn_sequence_loss_applies_splitter():
  obs_spec = {"obs": OBS, "mask": tspec.ArraySpec((2,), np.bool_)}
  qrnn = networks.make_q_rnn_network(OBS, ACT, input_fc_layer_params=(4,),
                                     lstm_size=4, device="cpu")
  agent = DqnAgent(
      ts.time_step_spec(obs_spec), ACT, qrnn, _adam,
      observation_and_action_constraint_splitter=lambda o: (o["obs"],
                                                            o["mask"]),
      train_sequence_length=4, device="cpu")
  b, t = 2, 4
  exp = tj.Trajectory(
      step_type=torch.tensor([0, 1, 1, 1]).repeat(b, 1),
      observation={"obs": torch.randn(b, t, 3),
                   "mask": torch.ones(b, t, 2, dtype=torch.bool)},
      action=torch.zeros(b, t, dtype=torch.int32), policy_info=(),
      next_step_type=torch.tensor([1, 1, 1, 2]).repeat(b, 1),
      reward=torch.ones(b, t), discount=torch.ones(b, t))
  _, info = agent.train(agent.init(), exp)
  assert np.isfinite(float(info.loss))


# -- one Adam step against the JAX agent ---------------------------------------

S, T = 8, 6


def _sequences(seed, masked):
  rng = np.random.RandomState(seed)
  step_type = rng.choice([0, 1, 2], size=(S, T), p=[0.15, 0.7, 0.15])
  obs = rng.randn(S, T, 3).astype(np.float32)
  exp = dict(
      step_type=step_type.astype(np.int32),
      action=rng.randint(0, 2, (S, T)).astype(np.int32),
      next_step_type=rng.choice([0, 1, 2], size=(S, T)).astype(np.int32),
      reward=rng.randn(S, T).astype(np.float32),
      discount=rng.choice([0.0, 1.0], size=(S, T), p=[0.2, 0.8]).astype(
          np.float32))
  if masked:
    mask = rng.uniform(size=(S, T, 2)) < 0.6
    mask[..., rng.randint(0, 2)] = True
    exp["observation"] = {"obs": obs, "mask": mask}
  else:
    exp["observation"] = obs
  return exp


def _agents(ddqn, masked):
  jobs_leaf = jspec.ArraySpec((3,), np.float32)
  jact = jspec.BoundedArraySpec((), np.int32, 0, 1)
  jobs = ({"obs": jobs_leaf, "mask": jspec.ArraySpec((2,), np.bool_)}
          if masked else jobs_leaf)
  tobs = ({"obs": OBS, "mask": tspec.ArraySpec((2,), np.bool_)}
          if masked else OBS)
  splitter = (lambda o: (o["obs"], o["mask"])) if masked else None
  hp = dict(gamma=0.9, target_update_tau=0.05, target_update_period=1,
            train_sequence_length=T,
            observation_and_action_constraint_splitter=splitter)
  jagent = (JaxDdqnAgent if ddqn else JaxDqnAgent)(
      jts.time_step_spec(jobs), jact,
      jnetworks.make_q_rnn_network(jobs_leaf, jact, **RNN), optax.adam(1e-3),
      td_errors_loss_fn=jcommon.element_wise_huber_loss, **hp)
  tagent = (DdqnAgent if ddqn else DqnAgent)(
      ts.time_step_spec(tobs), ACT,
      networks.make_q_rnn_network(OBS, ACT, **RNN, device="cpu"), _adam,
      td_errors_loss_fn=common.element_wise_huber_loss, device="cpu", **hp)
  return jagent, tagent


def _compare(jstate, tstate, msg):
  host = jax.device_get(jstate)
  adam = host.opt_state[0]
  for tag, tree, net in (("q", host.q_params, tstate.q_network),
                         ("target", host.target_q_params,
                          tstate.target_q_network)):
    expect = convert.q_rnn_params_to_state_dict(tree)
    for k, v in net.state_dict().items():
      assert_close(v, expect[k], err_msg=f"{msg} {tag}.{k}")
  params = list(tstate.q_network.parameters())
  for i, (mu, nu) in enumerate(zip(
      convert.q_rnn_params_to_state_dict(adam.mu).values(),
      convert.q_rnn_params_to_state_dict(adam.nu).values())):
    st = tstate.optimizer.state[params[i]]
    assert_close(st["exp_avg"], mu, err_msg=f"{msg} mu.{i}")
    assert_close(st["exp_avg_sq"], nu, atol=1e-9, err_msg=f"{msg} nu.{i}")
    assert float(st["step"]) == float(adam.count)
  assert tstate.train_step == int(host.train_step)


@pytest.mark.parametrize("ddqn", [False, True], ids=["dqn", "ddqn"])
@pytest.mark.parametrize("masked", [False, True],
                         ids=["no_splitter", "splitter"])
def test_sequence_train_step_matches_jax(ddqn, masked):
  """A JAX step gives Adam moments; the state crosses by `convert`, and
  both sides take one more step on the same sequences."""
  jagent, tagent = _agents(ddqn, masked)
  jtrain = jax.jit(jagent.train)
  to_j = lambda e: jtj.Trajectory(policy_info=(), **jax.tree_util.tree_map(
      jnp.asarray, e))
  to_t = lambda e: tj.Trajectory(policy_info=(), **jax.tree_util.tree_map(
      torch.from_numpy, e))
  jstate, _ = jtrain(jagent.init(jax.random.key(0)),
                     to_j(_sequences(0, masked)))
  host = jax.device_get(jstate)
  adam = host.opt_state[0]
  tstate = convert.load_dqn_agent_state(tagent.init(), convert.
                                        dqn_agent_state_to_torch(
      host.q_params, host.target_q_params, adam.mu, adam.nu, adam.count,
      host.train_step, params_to_state_dict=convert.q_rnn_params_to_state_dict))
  _compare(jstate, tstate, "converted")
  exp = _sequences(1, masked)
  jstate, jinfo = jtrain(jstate, to_j(exp))
  tstate, tinfo = tagent.train(tstate, to_t(exp))
  assert_close(tinfo.loss, jinfo.loss, err_msg="loss")
  assert tuple(tinfo.extra.td_loss.shape) == (S, T - 1)
  assert_close(tinfo.extra.td_loss, jinfo.extra.td_loss, err_msg="td_loss")
  assert_close(tinfo.extra.td_error, jinfo.extra.td_error, err_msg="td_error")
  _compare(jstate, tstate, "step 2")


# -- fused iterations of recurrent DDQN on CartPole ----------------------------

B, CAP, SAMPLE, SEQ, LIMIT = 8, 32, 16, 4, 12
INITIAL, ITERS = 8, 3
LOOP_HP = dict(epsilon_greedy=0.1, gamma=0.99, target_update_tau=0.05,
               target_update_period=2, train_sequence_length=SEQ)


def _jax_loop():
  env = BatchedJaxEnv(JaxCartPole(max_episode_steps=LIMIT), batch_size=B)
  tss, asp = env.time_step_spec(), env.action_spec()
  agent = JaxDdqnAgent(
      tss, asp, jnetworks.make_q_rnn_network(tss.observation, asp, **RNN),
      optax.adam(1e-3), td_errors_loss_fn=jcommon.element_wise_squared_loss,
      **LOOP_HP)
  replay = JaxUniformReplay(jtj.trajectory_spec(tss, asp), B, CAP)
  return JaxFusedTrainLoop(env, agent, replay,
                           metrics=jmetrics.standard_collect_metrics(5),
                           sample_batch_size=SAMPLE)


def _torch_loop(q_params):
  env = BatchedTorchEnv(CartPole(max_episode_steps=LIMIT), B, device="cpu")
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = networks.make_q_rnn_network(tss.observation, asp, **RNN,
                                     device="cpu")
  qnet.load_state_dict(convert.q_rnn_params_to_state_dict(q_params))
  agent = DdqnAgent(tss, asp, qnet, _adam,
                    td_errors_loss_fn=common.element_wise_squared_loss,
                    device="cpu", **LOOP_HP)
  replay = UniformReplay(tj.trajectory_spec(tss, asp), B, CAP, device="cpu")
  return FusedTrainLoop(env, agent, replay,
                        metrics=metrics.standard_collect_metrics(5),
                        sample_batch_size=SAMPLE, device="cpu")


def _jax_loop_draws(key, asp):
  _, k_driver, k_collect, k_loop = jax.random.split(key, 4)
  records = [{"env_reset": [jax_reset_draws(k_driver, B)]},
             jax_collect_draws(k_collect, INITIAL, B, asp)]
  k = k_loop
  for i in range(ITERS):
    k, k_c, k_s = jax.random.split(k, 3)
    num_valid = min(INITIAL + i + 1, CAP) - SEQ + 1
    records.append(jax_collect_draws(k_c, 1, B, asp))
    records.append(jax_sample_draws(jax.random.split(k_s, 1)[0], SAMPLE,
                                    num_valid, B))
  return merge_draws(*records)


def test_recurrent_ddqn_fused_iterations_match_jax():
  jloop = _jax_loop()
  key = jax.random.key(3)

  def init_and_run(k):
    state = jloop.init(k, initial_collect_steps=INITIAL)
    return state.agent_state.q_params, jloop.run(state, ITERS)

  q0, (jstate, jlosses) = jax.jit(init_and_run)(key)
  tloop = _torch_loop(jax.device_get(q0))
  draws = ReplayDraws(_jax_loop_draws(key, jloop.env.action_spec()))
  tstate = tloop.init(draws=draws, initial_collect_steps=INITIAL)
  tstate, tlosses = tloop.run(tstate, ITERS)
  assert all(v == 0 for v in draws.remaining().values())
  assert_close(tlosses, jlosses, err_msg="losses")
  ja = jax.device_get(jstate.agent_state)
  for tree, net in ((ja.q_params, tstate.agent_state.q_network),
                    (ja.target_q_params, tstate.agent_state.target_q_network)):
    expect = convert.q_rnn_params_to_state_dict(tree)
    for k, v in net.state_dict().items():
      assert_close(v, expect[k], err_msg=k)
  storage, jstorage = tstate.replay_state.storage, jstate.replay_state.storage
  for f in ("step_type", "action", "next_step_type"):
    assert_equal(getattr(storage, f), getattr(jstorage, f), f)
  for f in ("observation", "reward", "discount"):
    assert_close(getattr(storage, f), getattr(jstorage, f), err_msg=f)
  assert (storage.step_type == ts.StepType.FIRST).any()
  # The driver carries the LSTM state across iterations.
  for a, b in zip(tstate.driver_state.policy_state,
                  jstate.driver_state.policy_state, strict=True):
    assert tuple(a.shape) == (B, 8)
    assert_close(a, b, err_msg="carry")
