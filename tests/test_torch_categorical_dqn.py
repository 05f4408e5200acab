"""Port parity: C51 (`agents_tpu_torch.agents.categorical_dqn`,
`agents_tpu_torch.policies.CategoricalQPolicy`) against the JAX package.

`project_distribution` is compared on random supports, atoms outside the
grid included; the golden values follow `tests/test_golden_losses.py`
(`test_project_distribution_golden`, `test_c51_golden_loss`). The Adam
train steps start from a whole JAX agent state carried across by
`convert.dqn_agent_state_to_torch`: losses, cross-entropies, params,
target params and Adam moments agree to rtol 1e-5 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from agents_tpu import networks as jnetworks
from agents_tpu.agents.categorical_dqn import \
    CategoricalDqnAgent as JaxCategoricalDqnAgent
from agents_tpu.agents.categorical_dqn import \
    project_distribution as jax_project_distribution
from agents_tpu.policies.wrappers import GreedyPolicy as JaxGreedyPolicy
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch.agents.categorical_dqn import (CategoricalDqnAgent,
                                                     project_distribution)
from agents_tpu_torch.networks import Network, make_categorical_q_network
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import assert_close, assert_equal

torch.set_num_threads(1)

OBS, NUM_ACTIONS, ATOMS = (6, 6, 2), 3, 11
CONV, FC = ((4, 3, 2),), (16,)
S = 12


@pytest.mark.parametrize("b,n,m,spread", [(8, 11, 7, 1.0), (16, 51, 51, 3.0),
                                          (4, 5, 9, 0.2)])
def test_project_distribution_matches_jax(b, n, m, spread):
  """Source atoms reach past both ends of the grid (clipped) and fall
  between grid points (split)."""
  rng = np.random.RandomState(n)
  grid = np.linspace(-2.0, 2.0, m).astype(np.float32)
  supports = (rng.randn(b, n) * spread * 2).astype(np.float32)
  weights = rng.dirichlet(np.ones(n), size=b).astype(np.float32)
  expect = jax_project_distribution(jnp.asarray(supports),
                                    jnp.asarray(weights), jnp.asarray(grid))
  got = project_distribution(torch.from_numpy(supports),
                             torch.from_numpy(weights), torch.from_numpy(grid))
  assert tuple(got.shape) == (b, m)
  assert_close(got, expect)
  assert_close(got.sum(-1), np.ones(b, np.float32))


def test_project_distribution_golden():
  target = torch.tensor([-1.0, 0.0, 1.0])
  out = project_distribution(torch.tensor([[-1.0, 1.0]]),
                             torch.tensor([[0.5, 0.5]]), target)
  assert_close(out[0], [0.5, 0.0, 0.5], atol=1e-6)
  out = project_distribution(torch.tensor([[-2.0, 0.5]]),
                             torch.tensor([[0.4, 0.6]]), target)
  assert_close(out[0], [0.4, 0.3, 0.3], atol=1e-6)


class ConstantLogitsNet(Network):
  """[B, 2 actions, 3 atoms] logits independent of obs: action 0 logits
  [ln 2, 0, 0], action 1 logits [0, 0, ln 2]."""

  num_atoms = 3

  def __init__(self, input_spec):
    super().__init__(input_spec)
    self.logits = nn.Parameter(torch.log(torch.tensor(
        [[2.0, 1.0, 1.0], [1.0, 1.0, 2.0]])))

  def forward(self, observation, step_type=None, network_state=()):
    batch = observation.shape[0]
    return self.logits.expand(batch, 2, 3), network_state


def test_c51_golden_loss():
  """gamma 0: the target is a delta at the reward. Row 0 (r=0, action 0):
  ce = ln 4; row 1 (r=1, action 1): ce = ln 2; loss = 1.5 ln 2."""
  tss = tts.time_step_spec(tspec.ArraySpec((2,), np.float32))
  act = tspec.BoundedArraySpec((), np.int32, 0, 1)
  agent = CategoricalDqnAgent(tss, act, ConstantLogitsNet(tss.observation),
                              lambda p: torch.optim.SGD(p, lr=0.0),
                              min_q_value=-1.0, max_q_value=1.0, gamma=0.0,
                              device="cpu")
  exp = ttj.Trajectory(
      step_type=torch.tensor([[0, 1], [0, 1]], dtype=torch.int32),
      observation=torch.tensor([[[1., 2.], [5., 6.]], [[3., 4.], [7., 8.]]]),
      action=torch.tensor([[0, 0], [1, 1]], dtype=torch.int32),
      policy_info=(),
      next_step_type=torch.tensor([[1, 1], [1, 1]], dtype=torch.int32),
      reward=torch.tensor([[0., 0.], [1., 1.]]),
      discount=torch.tensor([[1., 1.], [1., 1.]]))
  _, info = agent.train(agent.init(), exp)
  np.testing.assert_allclose(float(info.loss), 1.5 * np.log(2.0), rtol=1e-6)
  assert_close(info.extra.cross_entropy, [np.log(4.0), np.log(2.0)])


def _agents(period):
  jobs = jspec.BoundedArraySpec(OBS, np.float32, 0.0, 1.0)
  jact = jspec.BoundedArraySpec((), np.int32, 0, NUM_ACTIONS - 1)
  jnet = jnetworks.make_categorical_q_network(
      jobs, jact, num_atoms=ATOMS, conv_layer_params=CONV,
      fc_layer_params=FC)
  kwargs = dict(min_q_value=-3.0, max_q_value=3.0, epsilon_greedy=0.1,
                gamma=0.9, target_update_tau=0.05,
                target_update_period=period)
  jagent = JaxCategoricalDqnAgent(jts.time_step_spec(jobs), jact, jnet,
                                  optax.adam(1e-3), **kwargs)
  tobs = tspec.BoundedArraySpec(OBS, np.float32, 0.0, 1.0)
  tact = tspec.BoundedArraySpec((), np.int32, 0, NUM_ACTIONS - 1)
  tnet = make_categorical_q_network(
      tobs, tact, num_atoms=ATOMS, conv_layer_params=CONV,
      fc_layer_params=FC, device="cpu")
  tagent = CategoricalDqnAgent(tts.time_step_spec(tobs), tact, tnet,
                               lambda p: torch.optim.Adam(p, lr=1e-3),
                               device="cpu", **kwargs)
  return jagent, tagent


def _experiences(n, seed=0):
  rng = np.random.RandomState(seed)
  return [dict(
      step_type=rng.choice([0, 1, 2], size=(S, 2),
                           p=[0.2, 0.6, 0.2]).astype(np.int32),
      observation=rng.rand(S, 2, *OBS).astype(np.float32),
      action=rng.randint(0, NUM_ACTIONS, (S, 2)).astype(np.int32),
      next_step_type=rng.choice([0, 1, 2], size=(S, 2)).astype(np.int32),
      reward=(rng.randn(S, 2) * 2).astype(np.float32),
      discount=rng.choice([0.0, 1.0], size=(S, 2)).astype(np.float32))
      for _ in range(n)]


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
  params = list(tstate.q_network.parameters())
  for i, name in enumerate(mu):
    st = tstate.optimizer.state[params[i]]
    assert_close(st["exp_avg"], mu[name], err_msg=f"{msg} mu.{name}")
    assert_close(st["exp_avg_sq"], nu[name], rtol=1e-5, atol=1e-9,
                 err_msg=f"{msg} nu.{name}")
  assert tstate.train_step == int(host.train_step)


def test_c51_adam_steps_match_optax_from_converted_state():
  """One JAX step gives Adam nonzero moments; the whole agent state is
  carried across and both sides take two more steps. With period 2 the
  target moves on step 2 (tau 0.05) and lags on step 3."""
  jagent, tagent = _agents(period=2)
  jstate = jagent.init(jax.random.key(0))
  exps = _experiences(3)
  jtrain = jax.jit(jagent.train)
  to_j = lambda e: jtj.Trajectory(policy_info=(), **{
      k: jnp.asarray(v) for k, v in e.items()})
  to_t = lambda e: ttj.Trajectory(policy_info=(), **{
      k: torch.from_numpy(v) for k, v in e.items()})
  jstate, _ = jtrain(jstate, to_j(exps[0]))
  host = jax.device_get(jstate)
  adam = host.opt_state[0]
  tstate = convert.load_dqn_agent_state(tagent.init(), (
      convert.dqn_agent_state_to_torch(
          host.q_params, host.target_q_params, adam.mu, adam.nu, adam.count,
          host.train_step)))
  _compare_states(jstate, tstate, "converted")
  for i, e in enumerate(exps[1:], start=2):
    target_before = [p.clone() for p in tstate.target_q_network.parameters()]
    jstate, jinfo = jtrain(jstate, to_j(e))
    tstate, tinfo = tagent.train(tstate, to_t(e))
    assert_close(tinfo.loss, jinfo.loss, err_msg=f"step {i} loss")
    assert_close(tinfo.extra.cross_entropy, jinfo.extra.cross_entropy)
    assert (tinfo.extra.cross_entropy[to_t(e).step_type[:, 0] == 2] == 0).all()
    _compare_states(jstate, tstate, f"step {i}")
    moved = any(not torch.equal(a, b) for a, b in zip(
        target_before, tstate.target_q_network.parameters()))
    assert moved == (i % 2 == 0), f"step {i}"


def test_categorical_q_policy_greedy_actions_match_jax():
  jagent, tagent = _agents(period=1)
  jstate = jagent.init(jax.random.key(3))
  tstate = tagent.init()
  tstate.q_network.load_state_dict(
      convert.q_params_to_state_dict(jax.device_get(jstate.q_params)))
  obs = np.random.RandomState(1).rand(32, *OBS).astype(np.float32)
  jstep = jts.restart(jnp.asarray(obs), batch_size=32)
  tstep = tts.restart(torch.from_numpy(obs), batch_size=32)
  jq, _, _ = jagent._q_policy.q_values(jstate.q_params, jstep)
  with torch.no_grad():
    tq, _ = tagent._q_policy.q_values(tstate.q_network, tstep)
  assert_close(tq, jq)
  jaction = JaxGreedyPolicy(jagent._q_policy).action(
      jstate.q_params, jstep, (), jax.random.key(0)).action
  taction = tagent.policy.action(tagent.policy_params(tstate), tstep).action
  assert_equal(taction, jaction)
  assert taction.dtype == torch.int32


def test_c51_collect_policy_is_constant_epsilon_over_the_q_network():
  _, tagent = _agents(period=1)
  state = tagent.init()
  params = tagent.collect_policy_params(state)
  assert params is state.q_network
  step = tts.restart(torch.rand(4, *OBS), batch_size=4)
  greedy = tagent.policy.action(tagent.policy_params(state), step).action
  draws = ReplayDraws({
      "random_action": [np.array([2, 2, 2, 2], np.int32)],
      "explore": [np.array([0.05, 0.5, 0.09, 0.99], np.float32)]})
  action = tagent.collect_policy.action(params, step, (), draws).action
  assert_equal(action, np.where([True, False, True, False], 2,
                                greedy.numpy()))
