"""Port parity: the DQN agent, its losses and target updates
(`agents_tpu_torch.agents.dqn`, `agents_tpu_torch.utils.common`) against
the JAX package.

Golden values follow `tests/test_dqn_agent.py` (DummyNet, loss 740.69).
The Adam train steps start from a whole JAX `DqnAgentState` carried
across by `convert.dqn_agent_state_to_torch`; losses, parameters, target
parameters and Adam moments agree to rtol 1e-5 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from agents_tpu import networks as jnetworks
from agents_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu.utils import common as jcommon
from agents_tpu_torch.agents.dqn import DdqnAgent, DqnAgent
from agents_tpu_torch.networks import Network, make_q_network
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import common, convert
from test_torch_parity_utils import assert_close, assert_equal

torch.set_num_threads(1)


class DummyNet(Network):
  """Q(obs) = obs @ W + b with W = [[2, 1], [1, 1]], b = [1, 1]."""

  def __init__(self, input_spec):
    super().__init__(input_spec)
    self.w = nn.Parameter(torch.tensor([[2.0, 1.0], [1.0, 1.0]]))
    self.b = nn.Parameter(torch.tensor([1.0, 1.0]))

  def forward(self, observation, step_type=None, network_state=()):
    return observation.float() @ self.w + self.b, network_state


def _dummy_agent(cls=DqnAgent, **kwargs):
  tss = tts.time_step_spec(tspec.ArraySpec((2,), np.float32))
  asp = tspec.BoundedArraySpec((), np.int32, 0, 1)
  kwargs.setdefault("td_errors_loss_fn", common.element_wise_squared_loss)
  return cls(tss, asp, DummyNet(tss.observation),
             lambda p: torch.optim.SGD(p, lr=0.01), gamma=1.0,
             device="cpu", **kwargs)


def _dummy_experience(**overrides):
  fields = dict(
      step_type=torch.tensor([[0, 1], [0, 1]], dtype=torch.int32),
      observation=torch.tensor([[[1., 2.], [5., 6.]], [[3., 4.], [7., 8.]]]),
      action=torch.tensor([[0, 0], [1, 1]], dtype=torch.int32),
      policy_info=(),
      next_step_type=torch.tensor([[1, 1], [1, 1]], dtype=torch.int32),
      reward=torch.tensor([[10., 10.], [20., 20.]]),
      discount=torch.tensor([[0.9, 0.9], [0.9, 0.9]]))
  fields.update(overrides)
  return ttj.Trajectory(**fields)


@pytest.mark.parametrize("cls", [DqnAgent, DdqnAgent])
def test_loss_golden_value(cls):
  """(20.3^2 + 32.7^2) / 2 = 740.69; DDQN equals DQN with identical
  online and target nets."""
  agent = _dummy_agent(cls)
  state = agent.init()
  _, info = agent.train(state, _dummy_experience())
  np.testing.assert_allclose(float(info.loss), 740.69, rtol=1e-5)
  assert_close(info.extra.td_error, np.array([20.3, 32.7], np.float32))


def test_boundary_transitions_masked():
  agent = _dummy_agent()
  exp = _dummy_experience(
      step_type=torch.tensor([[2, 0], [0, 1]], dtype=torch.int32),
      next_step_type=torch.tensor([[0, 1], [1, 1]], dtype=torch.int32))
  _, info = agent.train(agent.init(), exp)
  np.testing.assert_allclose(float(info.loss), 1069.29 / 2, rtol=1e-5)
  assert float(info.extra.td_error[0]) == 0.0


def test_train_updates_and_target_lags():
  agent = _dummy_agent(target_update_period=2, target_update_tau=1.0)
  s0 = agent.init()
  w0 = s0.q_network.w.detach().clone()
  s1, _ = agent.train(s0, _dummy_experience())
  assert s1.train_step == 1
  assert not torch.equal(s1.q_network.w, w0)
  assert torch.equal(s1.target_q_network.w, w0)
  s2, _ = agent.train(s1, _dummy_experience())
  assert torch.equal(s2.target_q_network.w, s2.q_network.w)
  assert not s2.target_q_network.w.requires_grad


def test_collect_params_and_policies():
  agent = _dummy_agent()
  state = agent.init()
  assert set(agent.collect_policy_params(state)) == {"q", "train_step"}
  step = tts.restart(torch.tensor([[1.0, 2.0]]), batch_size=1)
  # obs [1, 2] -> q = [5, 4] -> greedy action 0.
  assert int(agent.policy.action(agent.policy_params(state), step)
             .action[0]) == 0
  with pytest.raises(ValueError):
    DqnAgent(agent.time_step_spec,
             tspec.BoundedArraySpec((), np.int32, 1, 2),
             agent.q_network, torch.optim.Adam, device="cpu")


# -- Adam train steps against optax from a converted DqnAgentState ---------

S, FC = 16, (16, 8)


def _experiences(n, seed=0):
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(n):
    st = rng.choice([0, 1, 2], size=(S, 2), p=[0.2, 0.6, 0.2])
    out.append(dict(
        step_type=st.astype(np.int32),
        observation=rng.randn(S, 2, 4).astype(np.float32),
        action=rng.randint(0, 2, (S, 2)).astype(np.int32),
        next_step_type=rng.choice([0, 1, 2], size=(S, 2)).astype(np.int32),
        reward=rng.randn(S, 2).astype(np.float32),
        discount=rng.choice([0.0, 1.0], size=(S, 2)).astype(np.float32)))
  return out


def _adam_agents(period):
  jobs = jspec.BoundedArraySpec((4,), np.float32, -5.0, 5.0)
  jact = jspec.BoundedArraySpec((), np.int32, 0, 1)
  jnet = jnetworks.make_q_network(jobs, jact, fc_layer_params=FC)
  kwargs = dict(epsilon_greedy=0.1, gamma=0.99, target_update_tau=0.05,
                target_update_period=period)
  jagent = JaxDqnAgent(jts.time_step_spec(jobs), jact, jnet,
                       optax.adam(1e-3),
                       td_errors_loss_fn=jcommon.element_wise_squared_loss,
                       **kwargs)
  tobs = tspec.BoundedArraySpec((4,), np.float32, -5.0, 5.0)
  tact = tspec.BoundedArraySpec((), np.int32, 0, 1)
  tnet = make_q_network(tobs, tact, fc_layer_params=FC, device="cpu")
  tagent = DqnAgent(tts.time_step_spec(tobs), tact, tnet,
                    lambda p: torch.optim.Adam(p, lr=1e-3),
                    td_errors_loss_fn=common.element_wise_squared_loss,
                    device="cpu", **kwargs)
  return jagent, tagent


def _convert_state(jstate, tagent):
  host = jax.device_get(jstate)
  adam = host.opt_state[0]
  converted = convert.dqn_agent_state_to_torch(
      host.q_params, host.target_q_params, adam.mu, adam.nu, adam.count,
      host.train_step)
  return convert.load_dqn_agent_state(tagent.init(), converted)


def _compare_states(jstate, tstate, msg):
  host = jax.device_get(jstate)
  adam = host.opt_state[0]
  for tag, tree, net in (("q", host.q_params, tstate.q_network),
                         ("target", host.target_q_params,
                          tstate.target_q_network)):
    expect = convert.q_params_to_state_dict(tree)
    for k, v in net.state_dict().items():
      assert_close(v, expect[k], err_msg=f"{msg} {tag}.{k}")
  mu = convert.q_params_to_state_dict(adam.mu)
  nu = convert.q_params_to_state_dict(adam.nu)
  for i, name in enumerate(mu):
    st = tstate.optimizer.state[list(tstate.q_network.parameters())[i]]
    assert_close(st["exp_avg"], mu[name], err_msg=f"{msg} mu.{name}")
    assert_close(st["exp_avg_sq"], nu[name], rtol=1e-5, atol=1e-9,
                 err_msg=f"{msg} nu.{name}")
    assert float(st["step"]) == float(adam.count)
  assert tstate.train_step == int(host.train_step)


def test_adam_train_steps_match_optax_from_converted_state():
  """One JAX step gives Adam nonzero moments; the whole agent state is
  then carried across and both sides take two more steps. With period 2
  the target updates on step 2 (tau 0.05) and lags on step 3."""
  jagent, tagent = _adam_agents(period=2)
  jstate = jagent.init(jax.random.key(0))
  exps = _experiences(3)
  jtrain = jax.jit(jagent.train)
  to_j = lambda e: jtj.Trajectory(policy_info=(), **{
      k: jnp.asarray(v) for k, v in e.items()})
  to_t = lambda e: ttj.Trajectory(policy_info=(), **{
      k: torch.from_numpy(v) for k, v in e.items()})
  jstate, _ = jtrain(jstate, to_j(exps[0]))
  tstate = _convert_state(jstate, tagent)
  _compare_states(jstate, tstate, "converted")
  for i, e in enumerate(exps[1:], start=2):
    j_target_before = jax.device_get(jstate.target_q_params)
    jstate, jinfo = jtrain(jstate, to_j(e))
    tstate, tinfo = tagent.train(tstate, to_t(e))
    assert_close(tinfo.loss, jinfo.loss, err_msg=f"step {i} loss")
    assert_close(tinfo.extra.td_error, jinfo.extra.td_error)
    assert_close(tinfo.extra.td_loss, jinfo.extra.td_loss)
    _compare_states(jstate, tstate, f"step {i}")
    moved = not np.array_equal(
        jax.device_get(jstate.target_q_params)["params"]["Dense_0"]["bias"],
        j_target_before["params"]["Dense_0"]["bias"])
    assert moved == (i % 2 == 0), f"step {i}"


def test_torch_adam_equals_optax_adam():
  rng = np.random.RandomState(0)
  p0 = rng.randn(5, 3).astype(np.float32)
  grads = [rng.randn(5, 3).astype(np.float32) for _ in range(4)]
  opt = optax.adam(1e-3)
  jp, jopt = jnp.asarray(p0), opt.init(jnp.asarray(p0))
  tp = nn.Parameter(torch.from_numpy(p0.copy()))
  topt = torch.optim.Adam([tp], lr=1e-3)
  for g in grads:
    updates, jopt = opt.update(jnp.asarray(g), jopt, jp)
    jp = optax.apply_updates(jp, updates)
    tp.grad = torch.from_numpy(g)
    topt.step()
    assert_close(tp.detach(), jp)


def test_common_losses_and_updates_match_jax():
  rng = np.random.RandomState(0)
  x, y = (rng.randn(6, 3).astype(np.float32) * 3 for _ in range(2))
  tx, ty = torch.from_numpy(x), torch.from_numpy(y)
  assert_close(common.element_wise_huber_loss(tx, ty),
               jcommon.element_wise_huber_loss(x, y))
  assert_close(common.element_wise_squared_loss(tx, ty),
               jcommon.element_wise_squared_loss(x, y))
  w = rng.rand(6, 3).astype(np.float32)
  assert_close(common.aggregate_losses(tx, torch.from_numpy(w)),
               jcommon.aggregate_losses(jnp.asarray(x), jnp.asarray(w)))
  assert_close(common.aggregate_losses(tx, global_batch_size=4,
                                       regularization_loss=ty),
               jcommon.aggregate_losses(jnp.asarray(x), global_batch_size=4,
                                        regularization_loss=jnp.asarray(y)))
  actions = rng.randint(0, 3, 6)
  assert_equal(common.index_with_actions(tx, torch.from_numpy(actions)),
               jcommon.index_with_actions(jnp.asarray(x),
                                          jnp.asarray(actions)))
  for max_norm in (0.5, 1e3):
    grads = [torch.from_numpy(x.copy()), torch.from_numpy(y.copy())]
    common.clip_gradient_norms(grads, max_norm)
    jgrads = jcommon.clip_gradient_norms([jnp.asarray(x), jnp.asarray(y)],
                                         max_norm)
    for g, jg in zip(grads, jgrads):
      assert_close(g, jg)
  target = [torch.from_numpy(y.copy())]
  common.soft_variables_update([tx], target, tau=0.05)
  assert_close(target[0], jcommon.soft_variables_update(x, y, tau=0.05))
  assert not common.periodic_soft_update(3, 2, [tx], target, 1.0)
  assert common.periodic_soft_update(4, 2, [tx], target, 1.0)
  assert_equal(target[0], x)
