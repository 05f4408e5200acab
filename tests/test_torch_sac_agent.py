"""Port parity: the SAC agent (`agents_tpu_torch.agents.sac`) against the
JAX package's.

The golden losses are those of `tests/test_golden_losses.py:121-142`,
with the same linear networks written in torch. The Adam train steps
start from a whole JAX `SacAgentState` carried across by
`convert.sac_agent_state_to_torch`, with the train step's normals
re-derived from ``fold_in(key(17), step)`` and replayed into the port's
draw sites; losses, the five parameter sets, log alpha and the three
optimizers' moments agree to rtol 1e-5 / atol 1e-6 (the second moments
to atol 1e-9: they hold squared gradients near 1e-8) in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from agents_tpu import networks as jnetworks
from agents_tpu.agents.sac import SacAgent as JaxSacAgent
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch import distributions as tdist
from agents_tpu_torch.agents.sac import SacAgent
from agents_tpu_torch.networks import (Network, make_critic_network,
                                       make_sac_actor_network)
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import convert, nest_utils
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import (assert_close, jax_sac_train_draws,
                                     merge_draws)

torch.set_num_threads(1)

RTOL, ATOL, NU_ATOL = 1e-5, 1e-6, 1e-9

# -- golden losses (test_golden_losses.py:121-142) ---------------------------


class DeterministicDistActor(Network):
  """loc = obs @ [[0.5], [-0.5]] as a Deterministic: sample = loc and
  log_pi = 0."""

  def __init__(self, input_spec):
    super().__init__(input_spec)
    self.w = nn.Parameter(torch.tensor([[0.5], [-0.5]]))

  def forward(self, observation, step_type=None, network_state=()):
    return tdist.Deterministic(observation.float() @ self.w,
                               event_ndims=1), network_state


class LinearCritic(Network):
  """q = sum(obs) + scale * sum(action); both critics start at scale 2."""

  def __init__(self, input_spec, scale=2.0):
    super().__init__(input_spec)
    self.scale = scale
    self.s = nn.Parameter(torch.tensor(scale))

  def reset_parameters(self, generator=None):
    with torch.no_grad():
      self.s.fill_(self.scale)

  def forward(self, obs_and_action, step_type=None, network_state=()):
    obs, action = obs_and_action
    return obs.float().sum(-1) + self.s * action.float().sum(-1), \
        network_state


def _golden_experience():
  """test_golden_losses.py:59-74."""
  return ttj.Trajectory(
      step_type=torch.tensor([[0, 1], [0, 1]], dtype=torch.int32),
      observation=torch.tensor([[[1., 2.], [5., 6.]], [[3., 4.], [7., 8.]]]),
      action=torch.tensor([[[1.], [1.]], [[-1.], [-1.]]]),
      policy_info=(),
      next_step_type=torch.tensor([[1, 1], [1, 1]], dtype=torch.int32),
      reward=torch.tensor([[10., 10.], [20., 20.]]),
      discount=torch.tensor([[0.9, 0.9], [0.9, 0.9]]))


def test_sac_golden_losses():
  """log_pi = 0 and alpha = 1: critic (2*14^2 + 2*27.6^2) / 2 * 0.5 =
  478.88; actor -mean(q) = -mean([2, 6]) = -4; alpha 0."""
  obs = tspec.ArraySpec((2,), np.float32)
  act = tspec.BoundedArraySpec((1,), np.float32, -100.0, 100.0)
  tss = tts.time_step_spec(obs)
  sgd = lambda p: torch.optim.SGD(p, lr=0.0)  # noqa: E731
  agent = SacAgent(tss, act, LinearCritic((obs, act)),
                   DeterministicDistActor(obs), sgd, sgd, sgd, gamma=1.0,
                   initial_log_alpha=0.0, target_entropy=-1.0, device="cpu")
  _, info = agent.train(agent.init(), _golden_experience())
  np.testing.assert_allclose(float(info.extra.critic_loss), 478.88,
                             rtol=1e-5)
  np.testing.assert_allclose(float(info.extra.actor_loss), -4.0, rtol=1e-6)
  np.testing.assert_allclose(float(info.extra.alpha_loss), 0.0, atol=1e-7)
  np.testing.assert_allclose(float(info.loss), 478.88 - 4.0, rtol=1e-5)


# -- Adam train steps against optax from a converted SacAgentState ----------

S = 32


def _specs(module):
  return (module.BoundedArraySpec((3,), np.float32, -8.0, 8.0),
          module.BoundedArraySpec((1,), np.float32, -2.0, 2.0))


def sac_agents(actor_fc, critic_joint, critic_obs=(), **kwargs):
  """(JAX agent, port agent) of the same construction; the port's networks
  are drawn anew and take converted weights later."""
  jobs, jact = _specs(jspec)
  jagent = JaxSacAgent(
      jts.time_step_spec(jobs), jact,
      critic_network=jnetworks.make_critic_network(
          jobs, jact, observation_fc_layer_params=critic_obs,
          joint_fc_layer_params=critic_joint),
      actor_network=jnetworks.make_sac_actor_network(
          jobs, jact, fc_layer_params=actor_fc),
      actor_optimizer=optax.adam(3e-4), critic_optimizer=optax.adam(3e-4),
      alpha_optimizer=optax.adam(3e-4), **kwargs)
  tobs, tact = _specs(tspec)
  adam = lambda p: torch.optim.Adam(p, lr=3e-4)  # noqa: E731
  tagent = SacAgent(
      tts.time_step_spec(tobs), tact,
      make_critic_network(tobs, tact, observation_fc_layer_params=critic_obs,
                          joint_fc_layer_params=critic_joint, device="cpu"),
      make_sac_actor_network(tobs, tact, fc_layer_params=actor_fc,
                             device="cpu"),
      adam, adam, adam, device="cpu", **kwargs)
  return jagent, tagent


def _experiences(n, seed=0):
  rng = np.random.RandomState(seed)
  return [dict(
      step_type=rng.choice([0, 1, 2], size=(S, 2), p=[0.2, 0.6, 0.2]).astype(
          np.int32),
      observation=(rng.randn(S, 2, 3) * 2).astype(np.float32),
      action=rng.uniform(-2, 2, (S, 2, 1)).astype(np.float32),
      next_step_type=rng.choice([0, 1, 2], size=(S, 2)).astype(np.int32),
      reward=(rng.randn(S, 2) * 3).astype(np.float32),
      discount=rng.choice([0.0, 1.0], size=(S, 2), p=[0.1, 0.9]).astype(
          np.float32)) for _ in range(n)]


def _to_jax(e):
  return jtj.Trajectory(policy_info=(),
                        **{k: jnp.asarray(v) for k, v in e.items()})


def _to_torch(e):
  return ttj.Trajectory(policy_info=(),
                        **{k: torch.from_numpy(v) for k, v in e.items()})


def assert_sac_states_close(jstate, tstate, msg, rtol=RTOL, atol=ATOL,
                            nu_atol=NU_ATOL):
  """Networks, log alpha, the three optimizers' moments and counts, and
  the train step of a port `SacAgentState` against a JAX one."""
  expect = convert.sac_agent_state_to_torch(jax.device_get(jstate))
  for field in ("actor_network", "critic1_network", "critic2_network",
                "target_critic1_network", "target_critic2_network"):
    for k, v in getattr(tstate, field).state_dict().items():
      assert_close(v, expect[field][k], rtol, atol, f"{msg} {field}.{k}")
  assert_close(tstate.log_alpha.detach(), expect["log_alpha"], rtol, atol,
               f"{msg} log_alpha")
  for name in ("actor", "critic", "alpha"):
    optimizer = getattr(tstate, f"{name}_optimizer")
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
      st, ex = optimizer.state[p], expect[f"{name}_adam"][i]
      assert float(st["step"]) == float(ex["step"]), f"{msg} {name} step"
      assert_close(st["exp_avg"], ex["exp_avg"], rtol, atol,
                   f"{msg} {name} mu {i}")
      assert_close(st["exp_avg_sq"], ex["exp_avg_sq"], rtol, nu_atol,
                   f"{msg} {name} nu {i}")
  assert tstate.train_step == expect["train_step"]


@pytest.mark.parametrize("clip,period,critic_obs", [
    (None, 1, ()), (0.5, 2, (8,))])
def test_adam_train_steps_match_optax_from_converted_state(clip, period,
                                                           critic_obs):
  """One JAX step gives every Adam nonzero moments; the whole agent state
  is then carried across and both sides take three more steps. With
  clipping at 0.5 each group's gradients are clipped (the critic's norms
  run in the tens); with period 2 the targets move on steps 2 and 4 only.
  """
  jagent, tagent = sac_agents((16, 16), (16, 16), critic_obs,
                              target_update_tau=0.005,
                              target_update_period=period, gamma=0.99,
                              reward_scale_factor=0.5,
                              gradient_clipping=clip)
  jtrain = jax.jit(jagent.train)
  exps = _experiences(4)
  jstate, _ = jtrain(jagent.init(jax.random.key(0)), _to_jax(exps[0]))
  asp = _specs(jspec)[1]
  draws = ReplayDraws(merge_draws(*(jax_sac_train_draws(step, S, asp)
                                    for step in range(1, 4))))
  tstate = convert.load_sac_agent_state(
      tagent.init(draws=draws),
      convert.sac_agent_state_to_torch(jax.device_get(jstate)))
  assert_sac_states_close(jstate, tstate, "converted")
  for step, e in enumerate(exps[1:], start=2):
    jtarget = jax.device_get(jstate.target_critic1_params)
    jstate, jinfo = jtrain(jstate, _to_jax(e))
    tstate, tinfo = tagent.train(tstate, _to_torch(e))
    assert_close(tinfo.loss, jinfo.loss, RTOL, ATOL, f"step {step} loss")
    for name in ("critic_loss", "actor_loss", "alpha_loss"):
      assert_close(getattr(tinfo.extra, name), getattr(jinfo.extra, name),
                   RTOL, ATOL, f"step {step} {name}")
    assert_sac_states_close(jstate, tstate, f"step {step}")
    moved = not np.array_equal(
        jax.device_get(jstate.target_critic1_params)["params"]["Dense_0"][
            "kernel"], jtarget["params"]["Dense_0"]["kernel"])
    assert moved == (step % period == 0), f"step {step}"
  assert all(v == 0 for v in draws.remaining().values())


def test_actor_loss_puts_no_gradient_into_the_critics():
  """The critics' step follows from the critic loss alone: with the actor
  and alpha optimizers at lr 0, a train step moves the critics exactly as
  the critic loss's own gradient does, and leaves the actor unchanged."""
  _, tagent = sac_agents((16,), (16,))
  tagent.actor_optimizer_fn = lambda p: torch.optim.SGD(p, lr=0.0)
  tagent.critic_optimizer_fn = lambda p: torch.optim.SGD(p, lr=1.0)
  asp = _specs(jspec)[1]
  state = tagent.init(draws=ReplayDraws(jax_sac_train_draws(0, S, asp)))
  e = _experiences(1, seed=3)[0]
  transition = ttj.to_transition(_to_torch(e))
  first = lambda x: x[:, 0]  # noqa: E731
  ts, next_ts = (nest_utils.tree_map(first, t) for t in (
      transition.time_step, transition.next_time_step))
  critic_params = list(state.critic1_network.parameters()) + list(
      state.critic2_network.parameters())
  loss = tagent.critic_loss_weight * tagent.critic_loss(
      state, ts, first(transition.action_step.action), next_ts)
  grads = torch.autograd.grad(loss, critic_params)
  before = [p.detach().clone() for p in critic_params]
  actor_before = [p.detach().clone() for p in state.actor_network.parameters()]
  state = dataclasses.replace(state, draws=ReplayDraws(
      jax_sac_train_draws(0, S, asp)))
  tagent.train(state, _to_torch(e))
  for p, b, g in zip(critic_params, before, grads):
    assert_close(p.detach(), b - g, 1e-6, 1e-7)
  for p, b in zip(state.actor_network.parameters(), actor_before):
    assert torch.equal(p.detach(), b)


def test_agent_basics():
  jagent, tagent = sac_agents((16,), (16,))
  assert tagent.target_entropy == jagent.target_entropy == -1.0
  assert tagent.train_sequence_length == 2
  state = tagent.init()
  assert state.draws.device.type == "cpu" and state.train_step == 0
  # Critic 2 is drawn anew, not a copy of critic 1.
  assert not torch.equal(state.critic1_network.q_head.weight,
                         state.critic2_network.q_head.weight)
  assert all(torch.equal(a, b) for a, b in zip(
      state.critic1_network.parameters(),
      state.target_critic1_network.parameters()))
  assert not any(p.requires_grad
                 for p in state.target_critic2_network.parameters())
  assert tagent.policy_params(state) is state.actor_network
  e = _experiences(1)[0]
  bad = {k: np.concatenate([v, v], axis=1) for k, v in e.items()}
  with pytest.raises(ValueError, match="num_steps=2"):
    tagent.train(state, _to_torch(bad))
  with pytest.raises(ValueError, match="lives on"):
    SacAgent(tagent.time_step_spec, tagent.action_spec,
             tagent.critic_network, tagent.actor_network, torch.optim.Adam,
             torch.optim.Adam, torch.optim.Adam, device="meta")
