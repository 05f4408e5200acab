"""Port parity: the continuous distributions (`Normal`, `Independent`,
`SquashedNormal`, `Deterministic` of `agents_tpu_torch.distributions`) and
`GreedyPolicy._distribution` against the JAX package.

The JAX side samples from its own key; the same normals are drawn from
that key here and replayed into the port. `SquashedNormal` is held over
pre-squash values u with |u| up to 15, where ``softplus(-2u)`` leaves its
linear range on both sides. float32, rtol 1e-5 / atol 1e-5 (log-probs
near -30 carry ulps of 4e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu import distributions as jdist
from agents_tpu import networks as jnetworks
from agents_tpu.policies import actor_policy as jactor_policy
from agents_tpu.policies import q_policy as jq_policy
from agents_tpu.policies import wrappers as jwrappers
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu_torch import distributions as tdist
from agents_tpu_torch.networks import make_q_network, make_sac_actor_network
from agents_tpu_torch.policies import ActorPolicy, GreedyPolicy, QPolicy
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from test_torch_parity_utils import assert_close, assert_equal

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
B, D = 64, 2


def _t(x):
  return torch.from_numpy(np.array(x))


def _squashed(rng):
  """loc in [-13, 13] and scale in [0.05, 1.5] over [B, D], bounds [-2, 2]
  and [0, 3]: with unit normals the pre-squash u spans about ±15."""
  loc = rng.uniform(-13.0, 13.0, (B, D)).astype(np.float32)
  scale = rng.uniform(0.05, 1.5, (B, D)).astype(np.float32)
  low = np.array([-2.0, 0.0], np.float32)
  high = np.array([2.0, 3.0], np.float32)
  return (jdist.SquashedNormal(jnp.asarray(loc), jnp.asarray(scale),
                               jnp.asarray(low), jnp.asarray(high)),
          tdist.SquashedNormal(_t(loc), _t(scale), _t(low), _t(high)))


def test_squashed_normal_sample_and_log_prob_match_jax():
  jd, td = _squashed(np.random.RandomState(0))
  key = jax.random.key(1)
  eps = np.asarray(jax.random.normal(key, (B, D)))
  u = np.asarray(jd.loc) + np.asarray(jd.scale) * eps
  assert np.abs(u).max() > 14.0 and (u > 10).any() and (u < -10).any()
  draws = ReplayDraws({"s": [eps, eps]})
  jx, jlp = jd.sample_and_log_prob(key)
  tx, tlp = td.sample_and_log_prob(draws, site="s")
  assert_close(tx, jx, RTOL, ATOL)
  assert tuple(tlp.shape) == (B,)
  assert_close(tlp, jlp, RTOL, ATOL)
  assert_close(td.sample(draws, site="s"), jd.sample(key), RTOL, ATOL)
  assert_close(td.mode(), jd.mode(), RTOL, ATOL)
  assert_close(td.stddev(), jd.stddev(), RTOL, ATOL)


def test_squashed_normal_log_prob_of_values_matches_jax():
  """`log_prob` unsquashes its value (clipped 1e-6 inside the bounds);
  values are kept off the bounds, where the unsquash is exact."""
  rng = np.random.RandomState(2)
  loc = rng.uniform(-2.0, 2.0, (B, D)).astype(np.float32)
  scale = rng.uniform(0.1, 1.5, (B, D)).astype(np.float32)
  low, high = np.float32(-2.0), np.float32(2.0)
  value = rng.uniform(-1.9, 1.9, (B, D)).astype(np.float32)
  jd = jdist.SquashedNormal(jnp.asarray(loc), jnp.asarray(scale),
                            jnp.asarray(low), jnp.asarray(high))
  td = tdist.SquashedNormal(_t(loc), _t(scale), torch.tensor(low),
                            torch.tensor(high))
  assert_close(td.log_prob(_t(value)), jd.log_prob(jnp.asarray(value)),
               RTOL, ATOL)


def test_softplus_matches_jax_past_the_threshold():
  x = np.linspace(-40.0, 40.0, 801).astype(np.float32)
  from agents_tpu_torch.distributions.distributions import _softplus
  assert_close(_softplus(_t(x)), jax.nn.softplus(jnp.asarray(x)), 1e-6,
               1e-7)


def test_normal_and_independent_match_jax():
  rng = np.random.RandomState(3)
  loc = rng.randn(B, D).astype(np.float32)
  scale = rng.uniform(0.2, 2.0, (B, D)).astype(np.float32)
  jn = jdist.Independent(jdist.Normal(jnp.asarray(loc), jnp.asarray(scale)))
  tn = tdist.Independent(tdist.Normal(_t(loc), _t(scale)))
  key = jax.random.key(4)
  eps = np.asarray(jax.random.normal(key, (B, D)))
  tx = tn.sample(ReplayDraws({"n": [eps]}), site="n")
  assert_close(tx, jn.sample(key), RTOL, ATOL)
  assert_close(tn.log_prob(tx), jn.log_prob(jnp.asarray(tx.numpy())), RTOL,
               ATOL)
  assert_close(tn.entropy(), jn.entropy(), RTOL, ATOL)
  assert tuple(tn.entropy().shape) == (B,)
  assert_close(tn.mode(), jn.mode())


@pytest.mark.parametrize("event_ndims", [0, 1])
def test_deterministic_matches_jax(event_ndims):
  loc = np.random.RandomState(5).randn(4, 3).astype(np.float32)
  jd = jdist.Deterministic(jnp.asarray(loc), event_ndims=event_ndims)
  td = tdist.Deterministic(_t(loc), event_ndims=event_ndims)
  value = loc.copy()
  value[1, 2] += 1.0
  assert_equal(td.log_prob(_t(value)), jd.log_prob(jnp.asarray(value)))
  assert_equal(td.sample(None, (2,)), jd.sample(None, (2,)))
  assert_equal(td.entropy(), jd.entropy())
  assert_equal(td.mode(), jd.mode())
  x, lp = td.sample_and_log_prob(Draws(0, "cpu"))
  assert_equal(x, loc)
  assert_equal(lp, np.zeros((4,) if event_ndims else (4, 3), np.float32))


# -- GreedyPolicy._distribution ----------------------------------------------
# The port's `GreedyPolicy._distribution` used to raise NotImplementedError,
# where the JAX package returns a `Deterministic` at each wrapped
# distribution's mode with its event dims (wrappers.py:46-57). It now does
# the same; these tests hold it against the JAX policy's distribution.


def test_greedy_distribution_of_q_policy_matches_jax():
  jobs = jspec.ArraySpec((4,), np.float32)
  jact = jspec.BoundedArraySpec((), np.int32, 0, 2)
  jnet = jnetworks.make_q_network(jobs, jact, fc_layer_params=(16,))
  params = jnet.init_params(jax.random.key(0))
  jgreedy = jwrappers.GreedyPolicy(jq_policy.QPolicy(
      jts.time_step_spec(jobs), jact, jnet))
  tobs = tspec.ArraySpec((4,), np.float32)
  tact = tspec.BoundedArraySpec((), np.int32, 0, 2)
  tnet = make_q_network(tobs, tact, fc_layer_params=(16,), device="cpu")
  tnet.load_state_dict(convert.q_params_to_state_dict(jax.device_get(params)))
  tgreedy = GreedyPolicy(QPolicy(tts.time_step_spec(tobs), tact, tnet))

  obs = np.random.RandomState(6).randn(B, 4).astype(np.float32)
  jd = jgreedy.distribution(params, jts.restart(jnp.asarray(obs), B)).action
  td = tgreedy.distribution(tnet, tts.restart(_t(obs), B)).action
  assert isinstance(td, tdist.Deterministic) and td.event_ndims == 0
  assert td.event_ndims == jd.event_ndims
  assert_equal(td.mode(), jd.mode())
  other = (np.asarray(jd.mode()) + 1) % 3
  for value in (np.asarray(jd.mode()), other):
    assert_equal(td.log_prob(_t(value)), jd.log_prob(jnp.asarray(value)))


def test_greedy_distribution_of_sac_actor_matches_jax():
  jobs = jspec.BoundedArraySpec((3,), np.float32, -8.0, 8.0)
  jact = jspec.BoundedArraySpec((1,), np.float32, -2.0, 2.0)
  jnet = jnetworks.make_sac_actor_network(jobs, jact, fc_layer_params=(16,))
  params = jnet.init_params(jax.random.key(1))
  jpolicy = jactor_policy.ActorPolicy(jts.time_step_spec(jobs), jact, jnet)
  tobs = tspec.BoundedArraySpec((3,), np.float32, -8.0, 8.0)
  tact = tspec.BoundedArraySpec((1,), np.float32, -2.0, 2.0)
  tnet = make_sac_actor_network(tobs, tact, fc_layer_params=(16,),
                                device="cpu")
  tnet.load_state_dict(convert.sac_actor_params_to_state_dict(
      jax.device_get(params)))
  tpolicy = ActorPolicy(tts.time_step_spec(tobs), tact, tnet)

  obs = np.random.RandomState(7).randn(B, 3).astype(np.float32) * 3
  jstep, tstep = jts.restart(jnp.asarray(obs), B), tts.restart(_t(obs), B)
  jd = jwrappers.GreedyPolicy(jpolicy).distribution(params, jstep).action
  td = GreedyPolicy(tpolicy).distribution(tnet, tstep).action
  assert isinstance(td, tdist.Deterministic)
  assert td.event_ndims == jd.event_ndims == 1
  assert_close(td.mode(), jd.mode(), RTOL, ATOL)
  lp = td.log_prob(td.mode())
  assert tuple(lp.shape) == (B,)
  assert_equal(lp, jd.log_prob(jd.mode()))
  # The greedy action is the clipped squash of the mean.
  ja = jwrappers.GreedyPolicy(jpolicy).action(params, jstep).action
  ta = GreedyPolicy(tpolicy).action(tnet, tstep).action
  assert_close(ta, ja, RTOL, ATOL)
  assert tuple(ta.shape) == (B, 1)
