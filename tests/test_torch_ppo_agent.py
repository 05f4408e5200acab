"""Port parity: the PPO and REINFORCE agents (`agents_tpu_torch.agents.ppo`,
`.reinforce`) against the JAX package's.

The golden clip loss is `tests/test_golden_losses.py:225-269`'s, with the
same constant networks written in torch; the unclipped KL-penalty
surrogate is `tests/test_on_policy_agents.py:115-160`'s check. The train
steps start from a whole JAX agent state after one JAX step (so every
Adam moment, the normalizers and the schedule count are nonzero), carried
across by `convert`; both sides then train on a second numpy-made
trajectory, the port replaying the JAX permutations
(``jax.random.permutation`` of each epoch key). Losses, extras, both
networks, the Adam moments and counts, the normalizers, beta, the
learning rate and the train step agree to float32 rtol 1e-5 / atol 1e-6
(the second moments to atol 1e-9: they hold squared gradients).
"""
import dataclasses
import functools
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from agents_tpu import distributions as jdist
from agents_tpu import networks as jnetworks
from agents_tpu.agents.ppo import PPOAgent as JaxPPOAgent
from agents_tpu.agents.ppo import PPOKLPenaltyAgent as JaxPPOKLPenaltyAgent
from agents_tpu.agents.reinforce import ReinforceAgent as JaxReinforceAgent
from agents_tpu.networks.projection_networks import \
    NormalProjection as JaxNormalProjection
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch import distributions as tdist
from agents_tpu_torch.agents.ppo import (PPOAgent, PPOKLPenaltyAgent,
                                         PPOPolicy)
from agents_tpu_torch.agents.reinforce import ReinforceAgent
from agents_tpu_torch.networks import (Network, NormalProjection,
                                       make_actor_distribution_network,
                                       make_value_network)
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import common, convert, nest_utils
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import assert_close

torch.set_num_threads(1)

RTOL, ATOL, NU_ATOL = 1e-5, 1e-6, 1e-9
B, T = 4, 9                                   # 32 training frames

# -- golden clip loss (test_golden_losses.py:225-269) ------------------------


class ConstNormalActor(Network):
  """pi = Normal(b, 1) for every observation, b = 0."""

  def __init__(self, input_spec):
    super().__init__(input_spec)
    self.b = nn.Parameter(torch.zeros(()))

  def forward(self, observation, step_type=None, network_state=()):
    batch = observation.shape[0]
    return tdist.Normal(torch.zeros(batch) + self.b,
                        torch.ones(batch)), network_state


class ConstValueNet(Network):
  """V = 3."""

  def __init__(self, input_spec):
    super().__init__(input_spec)
    self.v = nn.Parameter(torch.tensor(3.0))

  def forward(self, observation, step_type=None, network_state=()):
    return self.v.expand(observation.shape[0]), network_state


def test_ppo_clip_loss_golden():
  """Old policy Normal(0, 2), new Normal(0, 1), actions 0: the ratio is
  exactly 2, clipped at 1.2. pg = (-1.2 + 2) / 2 = 0.4, clip fraction 1,
  value 0.5 * mean([4, 4]) = 2, KL(N(0,2) || N(0,1)) = ln 0.5 + 1.5,
  total (beta 0) 2.4."""
  obs_spec = tspec.ArraySpec((2,), np.float32)
  sact = tspec.BoundedArraySpec((), np.float32, -10.0, 10.0)
  agent = PPOAgent(tts.time_step_spec(obs_spec), sact,
                   lambda p: torch.optim.SGD(p, lr=0.0),
                   ConstNormalActor(obs_spec), ConstValueNet(obs_spec),
                   importance_ratio_clipping=0.2, entropy_regularization=0.0,
                   normalize_observations=False, normalize_rewards=False,
                   value_pred_loss_coef=0.5, device="cpu")
  state = agent.init()
  actions = torch.zeros(2)
  old_dist = tdist.Normal(torch.zeros(2), 2.0 * torch.ones(2))
  batch = (torch.zeros(2, 2), torch.ones(2, dtype=torch.int32), actions,
           old_dist, torch.full((2,), 3.0), torch.tensor([5.0, 1.0]),
           torch.tensor([1.0, -1.0]),
           common.log_probability(old_dist, actions), torch.ones(2))
  with torch.no_grad():
    total, (extra, mean_kl) = agent._loss(state, batch)
  np.testing.assert_allclose(float(extra.policy_gradient_loss), 0.4,
                             rtol=1e-6)
  np.testing.assert_allclose(float(extra.clip_fraction), 1.0)
  np.testing.assert_allclose(float(extra.value_estimation_loss), 2.0,
                             rtol=1e-6)
  np.testing.assert_allclose(float(mean_kl), np.log(0.5) + 2.0 - 0.5,
                             rtol=1e-6)
  np.testing.assert_allclose(float(extra.kl_penalty_loss), 0.0, atol=1e-7)
  np.testing.assert_allclose(float(total), 2.4, rtol=1e-6)


# -- agents of one construction on both sides --------------------------------


def _specs(m, discrete):
  if discrete:
    return (m.ArraySpec((4,), np.float32),
            m.BoundedArraySpec((), np.int32, 0, 1))
  return (m.ArraySpec((3,), np.float32),
          m.BoundedArraySpec((1,), np.float32, -2.0, 2.0))


def _jax_nets(discrete, fc=(16,)):
  obs, act = _specs(jspec, discrete)
  proj = functools.partial(JaxNormalProjection,
                           std_bias_initializer_value=math.log(
                               math.exp(0.35) - 1.0))
  return (jnetworks.make_actor_distribution_network(
      obs, act, fc_layer_params=fc, activation=fnn.tanh,
      continuous_projection=proj),
          jnetworks.make_value_network(obs, fc_layer_params=fc,
                                       activation=fnn.tanh))


def _torch_nets(discrete, fc=(16,)):
  obs, act = _specs(tspec, discrete)
  proj = functools.partial(NormalProjection,
                           std_bias_initializer_value=math.log(
                               math.exp(0.35) - 1.0))
  return (make_actor_distribution_network(
      obs, act, fc_layer_params=fc, activation=torch.tanh,
      continuous_projection=proj, device="cpu"),
          make_value_network(obs, fc_layer_params=fc, activation=torch.tanh,
                             device="cpu"))


SCHEDULE_STEPS = 10
VARIANTS = {
    # name: (discrete, JAX class, port class, kwargs, schedule)
    "plain": (True, JaxPPOAgent, PPOAgent, {"entropy_regularization": 0.01},
              False),
    "clip_schedule": (False, JaxPPOAgent, PPOAgent,
                      {"gradient_clipping": 0.5, "value_clipping": 0.5},
                      True),
    "adaptive_kl": (True, JaxPPOKLPenaltyAgent, PPOKLPenaltyAgent, {},
                    False),
}


def ppo_agents(variant):
  discrete, jcls, tcls, kwargs, schedule = VARIANTS[variant]
  kwargs = dict(num_epochs=2, num_minibatches=2, **kwargs)
  obs, act = _specs(jspec, discrete)
  lr = (optax.linear_schedule(3e-3, 0.0, SCHEDULE_STEPS) if schedule
        else 3e-3)
  jagent = jcls(jts.time_step_spec(obs), act, optax.adam(lr, eps=1e-5),
                *_jax_nets(discrete), **kwargs)
  tobs, tact = _specs(tspec, discrete)
  lr_schedule = (
      (lambda c: 1.0 - min(c, SCHEDULE_STEPS) / SCHEDULE_STEPS)
      if schedule else None)
  tagent = tcls(tts.time_step_spec(tobs), tact,
                lambda p: torch.optim.Adam(p, lr=3e-3, eps=1e-5),
                *_torch_nets(discrete), lr_schedule=lr_schedule,
                device="cpu", **kwargs)
  return jagent, tagent


def experience(seed, discrete, policy_info=True):
  """A numpy-made [B, T] trajectory: {field: array}, with the collect-time
  distribution's parameters and value predictions."""
  rng = np.random.RandomState(seed)
  step_type = rng.choice([0, 1, 2], size=(B, T), p=[0.15, 0.7, 0.15])
  out = dict(
      step_type=step_type.astype(np.int32),
      observation=(rng.randn(B, T, 4 if discrete else 3) * 1.5).astype(
          np.float32),
      next_step_type=np.concatenate(
          [step_type[:, 1:], rng.choice([1, 2], size=(B, 1))], 1).astype(
              np.int32),
      reward=(rng.randn(B, T) + 1.0).astype(np.float32),
      discount=rng.choice([0.0, 1.0], size=(B, T), p=[0.1, 0.9]).astype(
          np.float32))
  if discrete:
    out["action"] = rng.randint(0, 2, (B, T)).astype(np.int32)
    info = {"logits": (rng.randn(B, T, 2) * 0.5).astype(np.float32)}
  else:
    out["action"] = rng.uniform(-2, 2, (B, T, 1)).astype(np.float32)
    info = {"loc": rng.uniform(-1, 1, (B, T, 1)).astype(np.float32),
            "scale": rng.uniform(0.2, 0.6, (B, T, 1)).astype(np.float32)}
  if policy_info:
    info["value_prediction"] = rng.randn(B, T).astype(np.float32)
    out["policy_info"] = info
  return out


def _policy_info(info, lib, to):
  if info is None:
    return ()
  if "logits" in info:
    dist = lib.Categorical(to(info["logits"]))
  else:
    dist = lib.Independent(lib.Normal(to(info["loc"]), to(info["scale"])),
                           1)
  return {"dist": dist, "value_prediction": to(info["value_prediction"])}


def to_jax(e):
  fields = {k: jnp.asarray(v) for k, v in e.items() if k != "policy_info"}
  return jtj.Trajectory(
      policy_info=_policy_info(e.get("policy_info"), jdist, jnp.asarray),
      **fields)


def to_torch(e):
  fields = {k: torch.from_numpy(v) for k, v in e.items()
            if k != "policy_info"}
  return ttj.Trajectory(
      policy_info=_policy_info(e.get("policy_info"), tdist, torch.from_numpy),
      **fields)


def jax_permutations(key, num_epochs, n_items):
  """`PPOAgent.train`'s shuffles: one permutation per epoch key."""
  return {"ppo_permutation": [
      np.asarray(jax.random.permutation(k, n_items))
      for k in jax.random.split(key, num_epochs)]}


def _adam_close(optimizer, expect, msg):
  params = [p for g in optimizer.param_groups for p in g["params"]]
  assert len(params) == len(expect)
  for i, p in enumerate(params):
    st, ex = optimizer.state[p], expect[i]
    assert float(st["step"]) == float(ex["step"]), f"{msg} step"
    assert_close(st["exp_avg"], ex["exp_avg"], RTOL, ATOL, f"{msg} mu {i}")
    assert_close(st["exp_avg_sq"], ex["exp_avg_sq"], RTOL, NU_ATOL,
                 f"{msg} nu {i}")


def assert_ppo_states_close(jstate, tstate, msg):
  expect = convert.ppo_agent_state_to_torch(jax.device_get(jstate))
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
  if expect["schedule_count"] is not None:
    assert tstate.lr_scheduler.last_epoch == expect["schedule_count"]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_matches_optax_from_converted_state(variant):
  jagent, tagent = ppo_agents(variant)
  discrete = VARIANTS[variant][0]
  jtrain = jax.jit(jagent.train)
  e1, e2 = experience(0, discrete), experience(1, discrete)
  jstate, _ = jtrain(jagent.init(jax.random.key(0)), to_jax(e1),
                     key=jax.random.key(1))
  tstate = convert.load_ppo_agent_state(
      tagent.init(), convert.ppo_agent_state_to_torch(jax.device_get(jstate)))
  assert_ppo_states_close(jstate, tstate, "converted")

  k2 = jax.random.key(2)
  jstate2, jinfo = jtrain(jstate, to_jax(e2), key=k2)
  draws = ReplayDraws(jax_permutations(k2, 2, B * (T - 1)))
  tstate2, tinfo = tagent.train(tstate, to_torch(e2), draws=draws)
  assert all(v == 0 for v in draws.remaining().values())
  assert_close(tinfo.loss, jinfo.loss, RTOL, ATOL, "loss")
  for f in dataclasses.fields(tinfo.extra):
    assert_close(getattr(tinfo.extra, f.name), getattr(jinfo.extra, f.name),
                 RTOL, ATOL, f.name)
  assert_ppo_states_close(jstate2, tstate2, "trained")
  assert tstate2.train_step == 2
  if variant == "clip_schedule":
    # Eight optax steps into a 10-step decay: lr = 3e-3 * (1 - 8 / 10).
    np.testing.assert_allclose(tstate2.optimizer.param_groups[0]["lr"],
                               3e-3 * 0.2, rtol=1e-12)
  if variant == "adaptive_kl":
    beta = float(tstate2.kl_beta)
    assert beta != float(tstate.kl_beta)
    assert any(math.isclose(beta, float(tstate.kl_beta) * f, rel_tol=1e-6)
               for f in (1.5, 1 / 1.5))


@pytest.mark.parametrize("discrete", [True, False])
def test_compute_return_and_advantage_matches_jax(discrete):
  jagent, tagent = ppo_agents("plain" if discrete else "clip_schedule")
  # One JAX step moves the reward normalizer off its initial state.
  jstate, _ = jax.jit(jagent.train)(jagent.init(jax.random.key(0)),
                                    to_jax(experience(3, discrete)),
                                    key=jax.random.key(4))
  tstate = convert.load_ppo_agent_state(
      tagent.init(), convert.ppo_agent_state_to_torch(jax.device_get(jstate)))
  e = experience(5, discrete)
  jret, jadv = jagent.compute_return_and_advantage(jstate, to_jax(e))
  tret, tadv = tagent.compute_return_and_advantage(tstate, to_torch(e))
  assert tuple(tret.shape) == (B, T - 1)
  assert_close(tret, jret, RTOL, ATOL, "returns")
  assert_close(tadv, jadv, RTOL, ATOL, "advantages")


def test_kl_penalty_uses_the_unclipped_surrogate():
  """Port of `test_on_policy_agents.py:115-160`: with no ratio clipping
  (the KL-penalty variant) the policy-gradient loss is -mean(ratio * adv)
  at perturbed actor parameters, not the degenerate min() form."""
  obs, act = _specs(tspec, True)
  actor, value = _torch_nets(True)
  agent = PPOAgent(tts.time_step_spec(obs), act, torch.optim.Adam, actor,
                   value, importance_ratio_clipping=0.0,
                   normalize_advantages=False, initial_adaptive_kl_beta=1.0,
                   num_epochs=1, device="cpu")
  state = agent.init()
  exp = to_torch(experience(6, True))
  returns, advantages = agent.compute_return_and_advantage(state, exp)
  window = lambda x: nest_utils.tree_map(  # noqa: E731
      lambda v: v[:, :-1].reshape((-1,) + tuple(v.shape[2:])), x)
  st = window(exp.step_type)
  mask = (st != tts.StepType.LAST).float()
  old_dist = window(exp.policy_info["dist"])
  actions = window(exp.action)
  batch = (window(exp.observation), st, actions, old_dist,
           window(exp.policy_info["value_prediction"]), returns.reshape(-1),
           advantages.reshape(-1), common.log_probability(old_dist, actions),
           mask)
  with torch.no_grad():
    for p in actor.parameters():
      p.add_(0.05)
    _, (extra, _) = agent._loss(state, batch)
    obs_n = agent.obs_normalizer.normalize(state.obs_norm_state, batch[0])
    dist, _ = actor(obs_n, st, ())
  ratio = torch.exp(common.log_probability(dist, actions) - batch[7])
  denom = torch.clamp(mask.sum(), min=1.0)
  expected = -torch.sum(ratio * batch[6] * mask) / denom
  assert_close(extra.policy_gradient_loss, expected, 1e-5, 1e-7)
  clipped = -torch.sum(torch.minimum(ratio * batch[6], batch[6]) * mask) / denom
  assert not math.isclose(float(expected), float(clipped), rel_tol=1e-3)


def test_ppo_agent_basics():
  jagent, tagent = ppo_agents("plain")
  state = tagent.init()
  assert state.draws.device.type == "cpu" and state.train_step == 0
  params = tagent.policy_params(state)
  assert params["actor"] is state.actor_network
  assert params["normalizer"] is state.obs_norm_state
  assert isinstance(tagent.collect_policy, PPOPolicy)
  assert float(state.kl_beta) == 0.0 and state.lr_scheduler is None
  # One optimizer over the actor's, then the value network's parameters.
  opt_params = [p for g in state.optimizer.param_groups for p in g["params"]]
  assert opt_params == list(state.actor_network.parameters()) + list(
      state.value_network.parameters())
  actor, value = _torch_nets(True)
  obs, act = _specs(tspec, True)
  # Sharded minibatches are ported (test_torch_ppo_shards.py): a shard
  # count that does not split the 4 rows raises at train time.
  sharded = PPOAgent(tts.time_step_spec(obs), act, torch.optim.Adam, actor,
                     value, num_minibatch_shards=3, device="cpu")
  with pytest.raises(ValueError, match="num_minibatch_shards"):
    sharded.train(sharded.init(), to_torch(experience(0, True)))
  with pytest.raises(ValueError, match="lives on"):
    PPOAgent(tts.time_step_spec(obs), act, torch.optim.Adam, actor, value,
             device="meta")
  with pytest.raises(ValueError, match="minibatches"):
    tagent.num_minibatches = 5
    tagent.train(state, to_torch(experience(0, True)))


# -- REINFORCE -----------------------------------------------------------------


def _trailing_partial_episode(e):
  """Each row's last three frames run on past its last LAST, so the
  trailing-partial-episode mask drops them."""
  e["next_step_type"][:, -3:] = 1
  e["step_type"][:, -2:] = 1
  return e


@pytest.mark.parametrize("baseline", [True, False])
def test_reinforce_train_matches_optax_from_converted_state(baseline):
  """Two steps: one JAX step, the state carried across, then one step on
  each side from a second trajectory (with entropy and clipping)."""
  obs, act = _specs(jspec, True)
  jactor, jvalue = _jax_nets(True)
  kwargs = dict(gamma=0.99, entropy_regularization=0.01,
                gradient_clipping=1.0)
  jagent = JaxReinforceAgent(jts.time_step_spec(obs), act, jactor,
                             optax.adam(3e-3),
                             value_network=jvalue if baseline else None,
                             **kwargs)
  tactor, tvalue = _torch_nets(True)
  tobs, tact = _specs(tspec, True)
  tagent = ReinforceAgent(tts.time_step_spec(tobs), tact, tactor,
                          lambda p: torch.optim.Adam(p, lr=3e-3),
                          value_network=tvalue if baseline else None,
                          device="cpu", **kwargs)
  jtrain = jax.jit(jagent.train)
  e1, e2 = (_trailing_partial_episode(experience(seed, True,
                                                 policy_info=False))
            for seed in (7, 8))
  jstate, _ = jtrain(jagent.init(jax.random.key(0)), to_jax(e1))
  tstate = convert.load_reinforce_agent_state(
      tagent.init(),
      convert.reinforce_agent_state_to_torch(jax.device_get(jstate)))
  jstate, jinfo = jtrain(jstate, to_jax(e2))
  tstate, tinfo = tagent.train(tstate, to_torch(e2))
  assert_close(tinfo.loss, jinfo.loss, RTOL, ATOL, "loss")
  for name in ("policy_gradient_loss", "value_estimation_loss"):
    assert_close(getattr(tinfo.extra, name), getattr(jinfo.extra, name),
                 RTOL, ATOL, name)
  expect = convert.reinforce_agent_state_to_torch(jax.device_get(jstate))
  for k, v in tstate.actor_network.state_dict().items():
    assert_close(v, expect["actor_network"][k], RTOL, ATOL, k)
  if baseline:
    for k, v in tstate.value_network.state_dict().items():
      assert_close(v, expect["value_network"][k], RTOL, ATOL, k)
  else:
    assert expect["value_network"] is None
  _adam_close(tstate.optimizer, expect["adam"], "reinforce")
  assert tstate.train_step == expect["train_step"] == 2
