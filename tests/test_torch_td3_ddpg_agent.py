"""Port parity: the TD3 and DDPG agents (`agents_tpu_torch.agents.td3`,
`.ddpg`) against the JAX package's.

The golden losses are those of `tests/test_golden_losses.py:77-118`, with
the same linear networks written in torch. The Adam train steps start from
a whole JAX agent state carried across by `convert`, TD3's smoothing
normals re-derived from ``fold_in(key(23), step)`` and replayed into the
site "td3_target_noise"; losses, every network, the Adams' moments and
counts and the train step agree to rtol 1e-5 / atol 1e-6 (the second
moments to atol 1e-9: they hold squared gradients near 1e-8) in float32.
"""
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

from agents_tpu import networks as jnetworks
from agents_tpu.agents.ddpg import DdpgAgent as JaxDdpgAgent
from agents_tpu.agents.td3 import Td3Agent as JaxTd3Agent
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu_torch.agents.ddpg import DdpgAgent
from agents_tpu_torch.agents.agent import apply_gradients, first_transition
from agents_tpu_torch.agents.td3 import Td3Agent, Td3LossExtra
from agents_tpu_torch.networks import (Network, make_critic_network,
                                       make_deterministic_actor_network)
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import common, convert, nest_utils
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import assert_close
from test_torch_sac_agent import (LinearCritic, _experiences,
                                  _golden_experience, _to_jax, _to_torch)

torch.set_num_threads(1)

RTOL, ATOL, NU_ATOL = 1e-5, 1e-6, 1e-9
S = 32

# -- golden losses (test_golden_losses.py:77-118) ---------------------------


class LinearActor(Network):
  """a = obs @ [[0.5], [-0.5]] (raw actions, no squash)."""

  def __init__(self, input_spec):
    super().__init__(input_spec)
    self.w = nn.Parameter(torch.tensor([[0.5], [-0.5]]))

  def forward(self, observation, step_type=None, network_state=()):
    return observation.float() @ self.w, network_state


def _golden_specs():
  obs = tspec.ArraySpec((2,), np.float32)
  act = tspec.BoundedArraySpec((1,), np.float32, -100.0, 100.0)
  return tts.time_step_spec(obs), obs, act


def _sgd(lr=0.0):
  return lambda p: torch.optim.SGD(p, lr=lr)


def test_ddpg_golden_losses():
  """target_q = [10, 14], td targets [19, 32.6], q = [5, 5]: critic
  (14^2 + 27.6^2) / 2 = 478.88; actor -mean([2, 6]) = -4."""
  tss, obs, act = _golden_specs()
  agent = DdpgAgent(tss, act, LinearActor(obs), LinearCritic((obs, act)),
                    _sgd(), _sgd(), gamma=1.0, device="cpu")
  _, info = agent.train(agent.init(), _golden_experience())
  np.testing.assert_allclose(float(info.extra.critic_loss), 478.88,
                             rtol=1e-5)
  np.testing.assert_allclose(float(info.extra.actor_loss), -4.0, rtol=1e-6)
  np.testing.assert_allclose(float(info.loss), 478.88 - 4.0, rtol=1e-5)


def test_td3_golden_losses():
  """Twin critics of the same init (scale 2): min(tq1, tq2) = tq1 and the
  critic loss doubles DDPG's, 957.76; actor -4."""
  tss, obs, act = _golden_specs()
  agent = Td3Agent(tss, act, LinearActor(obs), LinearCritic((obs, act)),
                   _sgd(), _sgd(), gamma=1.0, target_policy_noise=0.0,
                   target_policy_noise_clip=0.0, device="cpu")
  draws = ReplayDraws({"td3_target_noise": [np.ones((2, 1), np.float32)]})
  _, info = agent.train(agent.init(draws=draws), _golden_experience())
  np.testing.assert_allclose(float(info.extra.critic_loss), 957.76,
                             rtol=1e-5)
  np.testing.assert_allclose(float(info.extra.actor_loss), -4.0, rtol=1e-6)


# -- Adam train steps against optax from a converted agent state -----------


def _specs(module):
  return (module.BoundedArraySpec((3,), np.float32, -8.0, 8.0),
          module.BoundedArraySpec((1,), np.float32, -2.0, 2.0))


def _agents(kind, actor_fc=(16, 16), critic_fc=(16, 16), agent_cls=None,
            **kwargs):
  """(JAX agent, port agent) of the same construction; the port's networks
  take converted weights later."""
  jobs, jact = _specs(jspec)
  jcls = JaxTd3Agent if kind == "td3" else JaxDdpgAgent
  jagent = jcls(jts.time_step_spec(jobs), jact,
                jnetworks.make_deterministic_actor_network(
                    jobs, jact, fc_layer_params=actor_fc),
                jnetworks.make_critic_network(jobs, jact,
                                              joint_fc_layer_params=critic_fc),
                optax.adam(3e-4), optax.adam(1e-3), **kwargs)
  tobs, tact = _specs(tspec)
  tcls = agent_cls or (Td3Agent if kind == "td3" else DdpgAgent)
  tagent = tcls(tts.time_step_spec(tobs), tact,
                make_deterministic_actor_network(tobs, tact, actor_fc,
                                                 device="cpu"),
                make_critic_network(tobs, tact,
                                    joint_fc_layer_params=critic_fc,
                                    device="cpu"),
                lambda p: torch.optim.Adam(p, lr=3e-4),
                lambda p: torch.optim.Adam(p, lr=1e-3), device="cpu",
                **kwargs)
  return jagent, tagent


NETWORKS = {"td3": ("actor_network", "critic1_network", "critic2_network",
                    "target_actor_network", "target_critic1_network",
                    "target_critic2_network"),
            "ddpg": ("actor_network", "critic_network",
                     "target_actor_network", "target_critic_network")}


def assert_states_close(kind, jstate, tstate, msg, rtol=RTOL, atol=ATOL):
  """Every network, both Adams' moments and counts, and the train step of
  a port TD3 or DDPG state against a JAX one."""
  to_torch = (convert.td3_agent_state_to_torch if kind == "td3"
              else convert.ddpg_agent_state_to_torch)
  expect = to_torch(jax.device_get(jstate))
  for field in NETWORKS[kind]:
    for k, v in getattr(tstate, field).state_dict().items():
      assert_close(v, expect[field][k], rtol, atol, f"{msg} {field}.{k}")
  for name in ("actor", "critic"):
    optimizer = getattr(tstate, f"{name}_optimizer")
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
      st, ex = optimizer.state.get(p, {}), expect[f"{name}_adam"][i]
      assert float(st["step"]) == float(ex["step"]), f"{msg} {name} step"
      assert_close(st["exp_avg"], ex["exp_avg"], rtol, atol,
                   f"{msg} {name} mu {i}")
      assert_close(st["exp_avg_sq"], ex["exp_avg_sq"], rtol, NU_ATOL,
                   f"{msg} {name} nu {i}")
  assert tstate.train_step == expect["train_step"]


def td3_target_draws(steps, sample_batch_size=S, shape=(1,)):
  """TD3's smoothing normals: ``normal(fold_in(key(23), step), [S,
  *action shape])`` (td3_agent.py:113-117, :146-147)."""
  return {"td3_target_noise": [
      np.asarray(jax.random.normal(jax.random.fold_in(jax.random.key(23),
                                                      step),
                                   (sample_batch_size,) + shape))
      for step in steps]}


def _run_against_optax(kind, steps=4, agent_cls=None, **kwargs):
  """One JAX step, the whole state carried across, then `steps` more on
  both sides; returns the port state and its actor Adam's count after
  each step."""
  jagent, tagent = _agents(kind, agent_cls=agent_cls, **kwargs)
  jtrain = jax.jit(jagent.train)
  exps = _experiences(steps + 1, seed=4)
  jstate, _ = jtrain(jagent.init(jax.random.key(0)), _to_jax(exps[0]))
  if kind == "td3":
    draws = ReplayDraws(td3_target_draws(range(1, steps + 1)))
    tstate = convert.load_td3_agent_state(
        tagent.init(draws=draws),
        convert.td3_agent_state_to_torch(jax.device_get(jstate)))
  else:
    tstate = convert.load_ddpg_agent_state(
        tagent.init(),
        convert.ddpg_agent_state_to_torch(jax.device_get(jstate)))
  assert_states_close(kind, jstate, tstate, "converted")
  out = []
  for step, e in enumerate(exps[1:], start=2):
    jstate, jinfo = jtrain(jstate, _to_jax(e))
    tstate, tinfo = tagent.train(tstate, _to_torch(e))
    assert_close(tinfo.loss, jinfo.loss, RTOL, ATOL, f"step {step} loss")
    for name in ("critic_loss", "actor_loss"):
      assert_close(getattr(tinfo.extra, name), getattr(jinfo.extra, name),
                   RTOL, ATOL, f"step {step} {name}")
    assert_states_close(kind, jstate, tstate, f"step {step}")
    p = next(tstate.actor_network.parameters())
    out.append(float(tstate.actor_optimizer.state[p]["step"]))
  if kind == "td3":
    assert all(v == 0 for v in draws.remaining().values())
  return tstate, out


@pytest.mark.parametrize("clip,target_period", [(None, 1), (0.5, 2)])
def test_td3_adam_steps_match_optax_with_a_delayed_actor(clip, target_period):
  """actor_update_period=2: the actor and its Adam count move on the even
  train steps only (the JAX step's `where` over both); the target actor
  follows the actor every `target_period` steps all the same."""
  tstate, counts = _run_against_optax(
      "td3", actor_update_period=2, target_update_period=target_period,
      target_update_tau=0.05, gamma=0.99, reward_scale_factor=0.5,
      exploration_noise_std=0.1, gradient_clipping=clip)
  # Train steps 2..5: the actor stepped at 2 and 4.
  assert counts == [1.0, 1.0, 2.0, 2.0]
  assert not torch.equal(tstate.target_actor_network.action_head.weight,
                         tstate.actor_network.action_head.weight)
  assert tstate.train_step == 5


@pytest.mark.parametrize("dqda,clip", [(None, None), (0.1, None),
                                       (0.1, 0.5), (None, 0.5)])
def test_ddpg_adam_steps_match_optax(dqda, clip):
  """With dqda_clipping at 0.1 the surrogate's dQ/da is clipped (the
  critic's slopes run past it); with gradient clipping at 0.5 each group's
  gradients are clipped."""
  _run_against_optax("ddpg", steps=3, target_update_tau=0.05, gamma=0.99,
                     dqda_clipping=dqda, gradient_clipping=clip,
                     ou_stddev=0.2, ou_damping=0.15)


class CriticsFirstTd3Agent(Td3Agent):
  """A mutation: the critics step before the actor loss is built, so the
  actor loss reads the post-step critic 1."""

  def train(self, agent_state, experience, weights=None):
    time_steps, actions, next_time_steps = first_transition(experience,
                                                            "Td3Agent")
    s = agent_state
    critic_loss = self.critic_loss(s, time_steps, actions, next_time_steps)
    critic_params = (list(s.critic1_network.parameters())
                     + list(s.critic2_network.parameters()))
    apply_gradients([(torch.autograd.grad(critic_loss, critic_params),
                      critic_params, s.critic_optimizer)], None)
    actor_loss = self.actor_loss(s, time_steps)
    actor_params = list(s.actor_network.parameters())
    apply_gradients([(torch.autograd.grad(actor_loss, actor_params),
                      actor_params, s.actor_optimizer)], None)
    train_step = s.train_step + 1
    for source, target in ((s.actor_network, s.target_actor_network),
                           (s.critic1_network, s.target_critic1_network),
                           (s.critic2_network, s.target_critic2_network)):
      common.periodic_soft_update(train_step, self.target_update_period,
                                  source.parameters(), target.parameters(),
                                  self.target_update_tau)
    extra = Td3LossExtra(actor_loss=actor_loss.detach(),
                         critic_loss=critic_loss.detach())
    return (dataclasses.replace(s, train_step=train_step),
            common.LossInfo(extra.actor_loss + extra.critic_loss, extra))


def test_stepping_the_critics_before_the_actor_loss_fails_the_parity():
  """The parity above catches the ordering: the mutated agent parts from
  optax at the first step."""
  with pytest.raises(AssertionError):
    _run_against_optax("td3", steps=1, agent_cls=CriticsFirstTd3Agent,
                       target_update_tau=0.05, gamma=0.99)


@pytest.mark.parametrize("dqda", [None, 0.1])
def test_ddpg_actor_loss_puts_no_gradient_into_the_critic(dqda):
  """With the actor at lr 0 and the critic at SGD lr 1, a train step moves
  the critic by exactly its own loss's gradient, in both actor-loss
  branches, and leaves the actor unchanged."""
  tobs, tact = _specs(tspec)
  agent = DdpgAgent(tts.time_step_spec(tobs), tact,
                    make_deterministic_actor_network(tobs, tact, (16,),
                                                     device="cpu"),
                    make_critic_network(tobs, tact, joint_fc_layer_params=(16,),
                                        device="cpu"),
                    _sgd(0.0), _sgd(1.0), dqda_clipping=dqda, device="cpu")
  state = agent.init()
  e = _to_torch(_experiences(1, seed=3)[0])
  transition = ttj.to_transition(e)
  first = lambda x: x[:, 0]  # noqa: E731
  ts, next_ts = (nest_utils.tree_map(first, t) for t in (
      transition.time_step, transition.next_time_step))
  critic_params = list(state.critic_network.parameters())
  grads = torch.autograd.grad(
      agent.critic_loss(state, ts, first(transition.action_step.action),
                        next_ts), critic_params)
  before = [p.detach().clone() for p in critic_params]
  actor_before = [p.detach().clone() for p in state.actor_network.parameters()]
  agent.train(state, e)
  for p, b, g in zip(critic_params, before, grads):
    assert_close(p.detach(), b - g, 1e-6, 1e-7)
  for p, b in zip(state.actor_network.parameters(), actor_before):
    assert torch.equal(p.detach(), b)


def test_agent_basics():
  jagent, tagent = _agents("td3", exploration_noise_std=0.3)
  assert tagent.train_sequence_length == 2
  assert tagent.collect_policy.scale == jagent.collect_policy.scale == 0.3
  state = tagent.init()
  assert state.draws.device.type == "cpu" and state.train_step == 0
  assert not torch.equal(state.critic1_network.q_head.weight,
                         state.critic2_network.q_head.weight)
  assert not any(p.requires_grad
                 for p in state.target_actor_network.parameters())
  assert tagent.policy_params(state) is state.actor_network
  _, dagent = _agents("ddpg", ou_stddev=0.2, ou_damping=0.15)
  assert (dagent.collect_policy.ou_stddev,
          dagent.collect_policy.ou_damping) == (0.2, 0.15)
  assert dagent.init().train_step == 0
  with pytest.raises(ValueError, match="lives on"):
    Td3Agent(tagent.time_step_spec, tagent.action_spec, tagent.actor_network,
             tagent.critic_network, torch.optim.Adam, torch.optim.Adam,
             device="meta")
