"""Port parity: the deterministic actor (`make_deterministic_actor_network`),
`DeterministicActorPolicy`, `GaussianPolicy` and `OUNoisePolicy` against
the JAX package's.

Weights cross from flax through
`convert.deterministic_actor_params_to_state_dict`; actions agree to rtol
1e-5 / atol 1e-6 in float32 at (16, 8) and at the TD3 width (256, 256).
The wrappers' normals are re-derived from the JAX policies' own key splits
(`wrappers.py:180-189, :219-231`) and replayed into the port's sites
"exploration_noise" and "ou_noise".
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu import networks as jnetworks
from agents_tpu.policies import actor_policy as jactor_policy
from agents_tpu.policies import wrappers as jwrappers
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu_torch.networks import make_deterministic_actor_network
from agents_tpu_torch.policies import (DeterministicActorPolicy,
                                       GaussianPolicy, GreedyPolicy,
                                       OUNoisePolicy)
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import assert_close, assert_equal

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
B = 64
TRUNC = 0.87962566103423978   # std of a unit normal cut at +-2


def _specs(module, act_shape=(1,), low=-2.0, high=2.0):
  return (module.BoundedArraySpec((3,), np.float32, -8.0, 8.0),
          module.BoundedArraySpec(act_shape, np.float32, low, high))


def _actors(fc, seed=0, **spec_kwargs):
  jobs, jact = _specs(jspec, **spec_kwargs)
  jnet = jnetworks.make_deterministic_actor_network(jobs, jact,
                                                    fc_layer_params=fc)
  params = jax.device_get(jnet.init_params(jax.random.key(seed)))
  tobs, tact = _specs(tspec, **spec_kwargs)
  tnet = make_deterministic_actor_network(tobs, tact, fc_layer_params=fc,
                                          device="cpu")
  tnet.load_state_dict(convert.deterministic_actor_params_to_state_dict(
      params))
  return jnet, params, tnet


def _obs(seed=0, n=B):
  return np.random.RandomState(seed).randn(n, 3).astype(np.float32) * 3


def _scaled_head(params, scale):
  """The action layer's kernel scaled, so tanh saturates on some rows."""
  head = params["params"]["Dense_0"]
  head["kernel"] = np.asarray(head["kernel"]) * scale
  return params


@pytest.mark.parametrize("fc,spec_kwargs", [
    ((16, 8), {}), ((256, 256), {}),
    ((16, 8), dict(act_shape=(2, 3), low=-1.0, high=3.0))])
def test_actor_matches_flax(fc, spec_kwargs):
  jnet, params, tnet = _actors(fc, **spec_kwargs)
  _scaled_head(params, 400.0)
  tnet.load_state_dict(convert.deterministic_actor_params_to_state_dict(
      params))
  obs = _obs()
  ja, _ = jnet.apply(params, jnp.asarray(obs))
  with torch.no_grad():
    ta, _ = tnet(torch.from_numpy(obs))
  assert tuple(ta.shape) == (B,) + _specs(tspec, **spec_kwargs)[1].shape
  assert ta.dtype == torch.float32
  assert_close(ta, ja, RTOL, ATOL)
  low, high = spec_kwargs.get("low", -2.0), spec_kwargs.get("high", 2.0)
  assert bool(((ta >= low) & (ta <= high)).all())
  assert bool((ta.abs() > 0.99 * high).any())   # some rows saturate


def test_per_element_bounds_match_flax():
  """Bounds that differ per element map through device buffers."""
  bounds = (np.array([-1.0, -2.0], np.float32), np.array([1.0, 5.0],
                                                          np.float32))
  jact = jspec.BoundedArraySpec((2,), np.float32, *bounds)
  tact = tspec.BoundedArraySpec((2,), np.float32, *bounds)
  jobs, tobs = _specs(jspec)[0], _specs(tspec)[0]
  jnet = jnetworks.make_deterministic_actor_network(jobs, jact, (8,))
  params = _scaled_head(jax.device_get(jnet.init_params(jax.random.key(4))),
                        300.0)
  tnet = make_deterministic_actor_network(tobs, tact, (8,), device="cpu")
  tnet.load_state_dict(convert.deterministic_actor_params_to_state_dict(
      params))
  obs = _obs(5)
  with torch.no_grad():
    ta, _ = tnet(torch.from_numpy(obs))
  assert_close(ta, jnet.apply(params, jnp.asarray(obs))[0], RTOL, ATOL)


def test_converter_maps_every_entry_and_refuses_others():
  _, params, tnet = _actors((16, 8))
  sd = convert.deterministic_actor_params_to_state_dict(params)
  assert list(sd) == list(tnet.state_dict())
  assert list(sd)[-2:] == ["action_head.weight", "action_head.bias"]
  bad = {"params": {**params["params"], "Dense_1": params["params"][
      "Dense_0"]}}
  with pytest.raises(ValueError, match="unexpected"):
    convert.deterministic_actor_params_to_state_dict(bad)


def test_init_distribution_and_reset_parameters():
  """The encoder's variance_scaling(2) truncated normals, a U(+-0.003)
  action layer, zero biases; `reset_parameters` redraws them all from its
  generator, the same generator state giving the same weights."""
  _, tact = _specs(tspec)
  tobs = tspec.ArraySpec((256,), np.float32)
  net = make_deterministic_actor_network(tobs, tact, (256, 256),
                                         device="cpu")
  for layer in net.encoder.layers:
    w = layer.weight.detach()
    std = math.sqrt(2.0 / w.shape[1])
    assert abs(float(w.std()) / std - 1.0) < 0.03
    assert float(w.abs().max()) <= 2.0 * std / TRUNC + 1e-6
    assert float(layer.bias.detach().abs().max()) == 0.0
  head = net.action_head.weight.detach()
  assert float(head.abs().max()) <= 0.003
  assert abs(float(head.std()) / (0.003 / math.sqrt(3.0)) - 1.0) < 0.15
  assert float(net.action_head.bias.detach().abs().max()) == 0.0
  before = [p.detach().clone() for p in net.parameters()]
  g = torch.Generator().manual_seed(9)
  net.reset_parameters(g)
  first = [p.detach().clone() for p in net.parameters()]
  assert not torch.equal(first[0], before[0])
  net.reset_parameters(torch.Generator().manual_seed(9))
  for a, b in zip(first, net.parameters()):
    assert torch.equal(a, b.detach())


def _time_steps(step_types, obs):
  n = len(step_types)
  j = jts.TimeStep(step_type=jnp.asarray(step_types, jnp.int32),
                   reward=jnp.zeros(n), discount=jnp.ones(n),
                   observation=jnp.asarray(obs))
  t = tts.TimeStep(step_type=torch.tensor(step_types, dtype=torch.int32),
                   reward=torch.zeros(n), discount=torch.ones(n),
                   observation=torch.from_numpy(obs))
  return j, t


def _policies(fc=(16, 8)):
  jnet, params, tnet = _actors(fc)
  jobs, jact = _specs(jspec)
  tobs, tact = _specs(tspec)
  jpol = jactor_policy.DeterministicActorPolicy(jts.time_step_spec(jobs),
                                                jact, jnet)
  tpol = DeterministicActorPolicy(tts.time_step_spec(tobs), tact, tnet)
  return jpol, params, tpol, tnet


def test_deterministic_policy_and_greedy_over_it():
  """`action` ignores the draws; `distribution` is a Deterministic at the
  action with one event dim, so `GreedyPolicy` acts the same and its
  log-prob of the action is 0 per row."""
  jpol, params, tpol, tnet = _policies()
  jstep, tstep = _time_steps([0] * 8, _obs(1, 8))
  ja = jpol.action(params, jstep, (), jax.random.key(0)).action
  with torch.no_grad():
    ta = tpol.action(tnet, tstep, (), None).action
    dist = tpol.distribution(tnet, tstep).action
    greedy = GreedyPolicy(tpol).action(tnet, tstep, (), None).action
  assert_close(ta, ja, RTOL, ATOL)
  jdist = jpol.distribution(params, jstep).action
  assert dist.event_ndims == jdist.event_ndims == 1
  assert_close(dist.loc, jdist.loc, RTOL, ATOL)
  assert_equal(greedy, ta)
  assert_equal(dist.log_prob(ta), np.zeros(8, np.float32))


def _gaussian_draws(keys, shape):
  """GaussianPolicy's normals: the policy key split into the wrapped
  policy's and the noise key, the latter once per action leaf."""
  out = []
  for k in keys:
    _, k_noise = jax.random.split(k)
    out.append(np.asarray(jax.random.normal(
        jax.random.split(k_noise, 1)[0], shape)))
  return out


def test_gaussian_policy_matches_jax_and_clips():
  """Noise at scale 3 pushes many actions past the bounds; both sides clip
  them into [-2, 2]."""
  jpol, params, tpol, tnet = _policies()
  jg, tg = jwrappers.GaussianPolicy(jpol, 3.0), GaussianPolicy(tpol, 3.0)
  assert tg.clip and tg.state_spec == ()
  jstep, tstep = _time_steps([1] * B, _obs(2))
  key = jax.random.key(3)
  ja = jg.action(params, jstep, (), key).action
  draws = ReplayDraws({"exploration_noise": _gaussian_draws([key], (B, 1))})
  with torch.no_grad():
    ta = tg.action(tnet, tstep, (), draws).action
  assert_close(ta, ja, RTOL, ATOL)
  assert bool((ta.abs() == 2.0).sum() > 10)
  assert draws.remaining() == {"exploration_noise": 0}
  with pytest.raises(NotImplementedError):
    tg.distribution(tnet, tstep)


def test_ou_noise_policy_over_three_steps_with_a_first_row():
  """Three steps of OU noise (damping 0.15, stddev 0.2) at B=4 from a zero
  state; row 2 starts a new episode at step 3, so its OU state restarts
  from zero there while the others carry theirs."""
  jpol, params, tpol, tnet = _policies()
  jou = jwrappers.OUNoisePolicy(jpol, ou_stddev=0.2, ou_damping=0.15)
  tou = OUNoisePolicy(tpol, ou_stddev=0.2, ou_damping=0.15)
  keys = jax.random.split(jax.random.key(5), 3)
  draws = ReplayDraws({"ou_noise": _gaussian_draws(keys, (4, 1))})
  jstate = jou.init_state(4)
  tstate = tou.init_state(4, device="cpu")
  assert tstate[0] == () and tuple(tstate[1][0].shape) == (4, 1)
  obs = _obs(6, 4)
  types = ([0, 0, 0, 0], [1, 1, 1, 1], [1, 1, 0, 1])
  ou_states = []
  for k, step_types in zip(keys, types):
    jstep, tstep = _time_steps(step_types, obs)
    jout = jou.action(params, jstep, jstate, k)
    with torch.no_grad():
      tout = tou.action(tnet, tstep, tstate, draws)
    assert_close(tout.action, jout.action, RTOL, ATOL)
    assert_close(tout.state[1][0], jout.state[1][0], RTOL, ATOL)
    jstate, tstate = jout.state, tout.state
    ou_states.append(tstate[1][0].clone())
  noise = [torch.from_numpy(d) * 0.2 for d in _gaussian_draws(keys, (4, 1))]
  expected = 0.85 * ou_states[1] + noise[2]
  expected[2] = noise[2][2]
  assert_close(ou_states[2], expected, RTOL, ATOL)
  assert draws.remaining() == {"ou_noise": 0}
