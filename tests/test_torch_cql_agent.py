"""Port parity: the CQL-SAC agent (`agents_tpu_torch.agents.cql`) against
the JAX package's.

The train steps start from a whole JAX `CqlSacAgentState` carried across
by `convert.cql_sac_agent_state_to_torch`; every draw of a step is
re-derived from the JAX step's key splits of ``fold_in(key(7), step)``
(cql_sac_agent.py:262-274, :118-137, :160-175) and replayed into the
port's sites. Losses, the CQL term and weight, the five networks, log
alpha, log cql alpha and the four optimizers' moments agree to rtol 1e-5
/ atol 1e-5 (the second moments to atol 1e-9) in float32: softmax
temperatures up to 50 scale Q inside the logsumexp, and the CQL gradients
sum 2n + 1 critic passes, so rounding reaches 1e-5 where SAC's stays at
1e-6.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agents_tpu import networks as jnetworks
from agents_tpu.agents.cql import CqlSacAgent as JaxCqlSacAgent
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu_torch.agents.cql import CqlSacAgent
from agents_tpu_torch.networks import (make_critic_network,
                                       make_sac_actor_network)
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import convert, nest_utils
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import assert_close, merge_draws
from test_torch_sac_agent import (_experiences, _specs, _to_jax, _to_torch,
                                  assert_sac_states_close)

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
NU_ATOL = 1e-9
S = 32


def cql_agents(actor_fc=(16, 16), critic_fc=(16, 16), critic_eps=1e-8,
               **kwargs):
  """(JAX agent, port agent) of the same construction; the critics' Adam
  takes `critic_eps`."""
  jobs, jact = _specs(jspec)
  jagent = JaxCqlSacAgent(
      jts.time_step_spec(jobs), jact,
      critic_network=jnetworks.make_critic_network(
          jobs, jact, joint_fc_layer_params=critic_fc),
      actor_network=jnetworks.make_sac_actor_network(
          jobs, jact, fc_layer_params=actor_fc),
      actor_optimizer=optax.adam(3e-4),
      critic_optimizer=optax.adam(3e-4, eps=critic_eps),
      alpha_optimizer=optax.adam(3e-4), **kwargs)
  tobs, tact = _specs(tspec)
  adam = lambda p: torch.optim.Adam(p, lr=3e-4)  # noqa: E731
  tagent = CqlSacAgent(
      tts.time_step_spec(tobs), tact,
      make_critic_network(tobs, tact, joint_fc_layer_params=critic_fc,
                          device="cpu"),
      make_sac_actor_network(tobs, tact, fc_layer_params=actor_fc,
                             device="cpu"),
      adam, lambda p: torch.optim.Adam(p, lr=3e-4, eps=critic_eps), adam,
      device="cpu", **kwargs)
  return jagent, tagent


def jax_cql_loss_draws(k_cql, n, sample_batch_size=S, shape=(1,)):
  """`_cql_loss`'s draws (:118-137): the uniforms in [0, 1) and the
  actor's normals, one key per sample split once for the one leaf."""
  k_rand, k_pi = jax.random.split(k_cql)
  return {"cql_uniform_actions": [np.asarray(jax.random.uniform(
              k_rand, (n, sample_batch_size) + shape, jnp.float32))],
          "cql_policy_noise": [np.stack([
              np.asarray(jax.random.normal(jax.random.split(k, 1)[0],
                                           (sample_batch_size,) + shape))
              for k in jax.random.split(k_pi, n)])]}


def jax_cql_train_draws(train_step, n, bc_debug_mode=False,
                        reward_noise=False, sample_batch_size=S,
                        shape=(1,)):
  """Every draw of `CqlSacAgent.train` at `train_step` (:262-274)."""
  key = jax.random.fold_in(jax.random.key(7), train_step)
  k_sac, k_cql = jax.random.split(key)
  k_critic, k_actor = jax.random.split(k_sac)
  normal = lambda k, s: np.asarray(jax.random.normal(k, s))  # noqa: E731
  out = jax_cql_loss_draws(k_cql, n, sample_batch_size, shape)
  out["cql_action_noise"] = [normal(jax.random.split(k_actor, 1)[0],
                                    (sample_batch_size,) + shape)]
  if not bc_debug_mode:
    k_actions, k_noise = jax.random.split(k_critic)
    out["cql_next_action_noise"] = [normal(jax.random.split(k_actions, 1)[0],
                                           (sample_batch_size,) + shape)]
    if reward_noise:
      out["cql_reward_noise"] = [normal(k_noise, (sample_batch_size,))]
  return out


def _saturated(e, rng):
  """A fifth of the actions exactly at the bounds, as noise-clipped
  datasets hold them."""
  e = dict(e)
  mask = rng.uniform(size=e["action"].shape) < 0.2
  e["action"] = np.where(mask, np.sign(e["action"]) * 2.0,
                         e["action"]).astype(np.float32)
  return e


def assert_cql_states_close(jstate, tstate, msg):
  """`assert_sac_states_close` plus log cql alpha and its Adam."""
  assert_sac_states_close(jstate, tstate, msg, RTOL, ATOL, NU_ATOL)
  expect = convert.cql_sac_agent_state_to_torch(jax.device_get(jstate))
  assert_close(tstate.log_cql_alpha.detach(), expect["log_cql_alpha"], RTOL,
               ATOL, f"{msg} log_cql_alpha")
  st = tstate.cql_alpha_optimizer.state.get(tstate.log_cql_alpha)
  ex = expect["cql_alpha_adam"][0]
  if st is None:   # never stepped: optax's count is 0, its moments 0
    assert float(ex["step"]) == 0.0
    return
  assert float(st["step"]) == float(ex["step"]), f"{msg} cql alpha step"
  assert_close(st["exp_avg"], ex["exp_avg"], RTOL, ATOL, f"{msg} cql mu")
  assert_close(st["exp_avg_sq"], ex["exp_avg_sq"], RTOL, NU_ATOL,
               f"{msg} cql nu")


CASES = {
    "bc_steps_cross": dict(num_bc_steps=2, softmax_temperature=50.0,
                           cql_alpha=10.0, num_cql_samples=4,
                           initial_log_alpha=math.log(0.1)),
    "lagrange_entropy_reward_noise": dict(
        use_lagrange_cql_alpha=True, cql_tau=2.0, cql_alpha=2.0,
        log_cql_alpha_clipping=(-1.0, 1.5), include_critic_entropy_term=True,
        reward_noise_variance=0.5, num_cql_samples=3,
        cql_alpha_learning_rate=1e-2),
    # The critics learn the CQL gap alone, which a shift of Q leaves
    # unchanged: the Q layers' biases have a gradient of 0 in exact
    # arithmetic and of rounding size (1e-9) in float32, which Adam's eps
    # 1e-8 would turn into steps of lr either way; eps 1e-3 keeps them at
    # rounding size on both sides.
    "bc_debug_clipped": dict(bc_debug_mode=True, gradient_clipping=0.5,
                             num_cql_samples=2, softmax_temperature=5.0,
                             critic_eps=1e-3),
    # log(cql_alpha) starts on the clip's lower bound: jnp.clip passes half
    # the gradient there, which the port's tensor clip does too.
    "lagrange_at_clip_bound": dict(
        use_lagrange_cql_alpha=True, cql_alpha=1.0, cql_tau=0.0,
        log_cql_alpha_clipping=(0.0, 2.0), num_cql_samples=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax_from_a_converted_state(case):
  """One JAX step gives every Adam nonzero moments; the whole state is then
  carried across and both sides take three more steps of the case's
  options, on batches with saturated actions. The clip-bound case starts
  from the initial state instead, so its first compared step takes the
  gradient at the bound (a `torch.clamp` there doubles the Lagrange
  Adam's moments and fails it)."""
  kwargs = dict(CASES[case], target_update_tau=0.005, gamma=0.99,
                reward_scale_factor=0.5)
  jagent, tagent = cql_agents(**kwargs)
  kwargs.pop("critic_eps", None)
  jtrain = jax.jit(jagent.train)
  rng = np.random.RandomState(7)
  exps = [_saturated(e, rng) for e in _experiences(4, seed=5)]
  jstate = jagent.init(jax.random.key(0))
  first = 0 if case == "lagrange_at_clip_bound" else 1
  if first:
    jstate, _ = jtrain(jstate, _to_jax(exps[0]))
  n = kwargs["num_cql_samples"]
  draws = ReplayDraws(merge_draws(*(jax_cql_train_draws(
      step, n, kwargs.get("bc_debug_mode", False),
      kwargs.get("reward_noise_variance", 0.0) > 0)
      for step in range(first, first + 3))))
  tstate = convert.load_cql_sac_agent_state(
      tagent.init(draws=draws),
      convert.cql_sac_agent_state_to_torch(jax.device_get(jstate)))
  assert_cql_states_close(jstate, tstate, "converted")
  for step, e in enumerate(exps[1:], start=2):
    jstate, jinfo = jtrain(jstate, _to_jax(e))
    tstate, tinfo = tagent.train(tstate, _to_torch(e))
    assert_close(tinfo.loss, jinfo.loss, RTOL, ATOL, f"step {step} loss")
    for name in ("critic_loss", "actor_loss", "alpha_loss", "cql_loss",
                 "cql_alpha", "cql_alpha_loss"):
      assert_close(getattr(tinfo.extra, name), getattr(jinfo.extra, name),
                   RTOL, ATOL, f"step {step} {name}")
    assert_cql_states_close(jstate, tstate, f"step {step}")
  assert all(v == 0 for v in draws.remaining().values())
  if case == "lagrange_at_clip_bound":
    assert float(tstate.log_cql_alpha.detach()) != 0.0   # it left the bound


def _batch(seed=2, saturate=False):
  e = _experiences(1, seed=seed)[0]
  if saturate:
    e = _saturated(e, np.random.RandomState(seed))
  transition = ttj.to_transition(_to_torch(e))
  first = lambda x: x[:, 0]  # noqa: E731
  return e, nest_utils.tree_map(first, transition.time_step), first(
      transition.action_step.action)


@pytest.mark.parametrize("n,temperature", [(1, 1.0), (4, 50.0)])
def test_cql_loss_matches_jax(n, temperature):
  """The CQL gap alone: the importance-weighted logsumexp over n policy
  and n uniform proposals, minus data Q, averaged over both critics; one
  critic forward of (2n + 1) S rows per critic on the port's side."""
  jagent, tagent = cql_agents(num_cql_samples=n,
                              softmax_temperature=temperature)
  jstate = jagent.init(jax.random.key(3))
  tstate = convert.load_cql_sac_agent_state(
      tagent.init(), convert.cql_sac_agent_state_to_torch(
          jax.device_get(jstate)))
  e, ts, actions = _batch(saturate=True)
  jexp = _to_jax(e)
  jts_ = jax.tree_util.tree_map(lambda x: x[:, 0], jexp)
  jtime_step = jts.TimeStep(step_type=jts_.step_type, reward=jts_.reward,
                            discount=jts_.discount,
                            observation=jts_.observation)
  key = jax.random.key(4)
  expected = jagent._cql_loss(
      (jstate.critic1_params, jstate.critic2_params), jstate, jtime_step,
      jts_.action, key)
  tstate = dataclasses.replace(tstate, draws=ReplayDraws(
      jax_cql_loss_draws(key, n)))
  with torch.no_grad():
    gap, q1, q2 = tagent._cql_terms(tstate, ts, actions)
  assert_close(gap, expected, RTOL, ATOL)
  jq1 = jagent._q(jstate.critic1_params, jtime_step, jts_.action)
  assert_close(q1, jq1, RTOL, ATOL)
  assert q2.shape == (S,)


def test_interior_clip_holds_saturated_actions_finite():
  """Data actions at the bounds are clipped 1e-3 of the range into the
  interior before the log-prob, as in JAX's `_log_prob`: finite, equal to
  JAX's, and the log-prob of the actions 0.004 inside the bounds."""
  jagent, tagent = cql_agents()
  jstate = jagent.init(jax.random.key(5))
  tstate = convert.load_cql_sac_agent_state(
      tagent.init(), convert.cql_sac_agent_state_to_torch(
          jax.device_get(jstate)))
  e, ts, actions = _batch(seed=6)
  actions = torch.where(torch.arange(S)[:, None] % 2 == 0, 2.0, -2.0)
  jtime_step = jts.TimeStep(
      step_type=jnp.asarray(e["step_type"][:, 0]),
      reward=jnp.asarray(e["reward"][:, 0]),
      discount=jnp.asarray(e["discount"][:, 0]),
      observation=jnp.asarray(e["observation"][:, 0]))
  expected = jagent._log_prob(jstate.actor_params, jtime_step,
                              jnp.asarray(actions.numpy()))
  with torch.no_grad():
    lp = tagent._data_log_prob(tstate.actor_network, ts, actions)
    inside = tagent._one_dist(tstate.actor_network, ts).log_prob(
        actions * (1.0 - 2e-3))
  assert bool(torch.isfinite(lp).all())
  assert_close(lp, expected, RTOL, 1e-4)
  assert_close(lp, inside, 1e-6, 1e-6)


def test_agent_basics():
  jagent, tagent = cql_agents(cql_alpha=3.0)
  state = tagent.init()
  assert state.draws.device.type == "cpu" and state.train_step == 0
  assert_close(state.log_cql_alpha.detach(), np.log(3.0), 1e-7, 0)
  assert state.cql_alpha_optimizer.param_groups[0]["lr"] == 1e-4
  assert tagent._log_uniform == pytest.approx(-math.log(4.0))
  assert tagent.target_entropy == jagent.target_entropy == -1.0
  with pytest.raises(ValueError, match="reward_noise_variance"):
    cql_agents(reward_noise_variance=-1.0)
