"""Port parity: the SAC networks (`make_sac_actor_network` with its
`TanhNormalProjection`, `make_critic_network`) and their converters
against flax, and their initial weight distributions.

Weights cross from flax through `convert.sac_actor_params_to_state_dict`
and `sac_critic_params_to_state_dict`; the actor's loc and scale and the
critic's Q agree to rtol 1e-5 / atol 1e-5 in float32 at (16, 8) and at
the SAC width (256, 256).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu import networks as jnetworks
from agents_tpu.specs import array_spec as jspec
from agents_tpu_torch.networks import (TanhNormalProjection,
                                       make_actor_distribution_network,
                                       make_critic_network,
                                       make_sac_actor_network)
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.utils import convert
from test_torch_parity_utils import assert_close, assert_equal

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
B = 64
TRUNC = 0.87962566103423978   # std of a unit normal cut at +-2


def _specs(spec_module, act_dims=1):
  obs = spec_module.BoundedArraySpec((3,), np.float32, -8.0, 8.0)
  act = spec_module.BoundedArraySpec((act_dims,), np.float32, -2.0, 2.0)
  return obs, act


def _actors(fc, seed=0, act_dims=1):
  jobs, jact = _specs(jspec, act_dims)
  jnet = jnetworks.make_sac_actor_network(jobs, jact, fc_layer_params=fc)
  params = jax.device_get(jnet.init_params(jax.random.key(seed)))
  tobs, tact = _specs(tspec, act_dims)
  tnet = make_sac_actor_network(tobs, tact, fc_layer_params=fc, device="cpu")
  tnet.load_state_dict(convert.sac_actor_params_to_state_dict(params))
  return jnet, params, tnet


def _critics(joint, obs_fc=(), seed=0):
  jobs, jact = _specs(jspec)
  jnet = jnetworks.make_critic_network(jobs, jact,
                                       observation_fc_layer_params=obs_fc,
                                       joint_fc_layer_params=joint)
  params = jax.device_get(jnet.init_params(jax.random.key(seed)))
  tobs, tact = _specs(tspec)
  tnet = make_critic_network(tobs, tact, observation_fc_layer_params=obs_fc,
                             joint_fc_layer_params=joint, device="cpu")
  tnet.load_state_dict(convert.sac_critic_params_to_state_dict(params))
  return jnet, params, tnet


def _obs(seed=0):
  return np.random.RandomState(seed).randn(B, 3).astype(np.float32) * 3


@pytest.mark.parametrize("fc,act_dims", [((16, 8), 1), ((256, 256), 1),
                                         ((16, 8), 3)])
def test_actor_matches_flax(fc, act_dims):
  jnet, params, tnet = _actors(fc, act_dims=act_dims)
  obs = _obs()
  jd, _ = jnet.apply(params, jnp.asarray(obs))
  with torch.no_grad():
    td, _ = tnet(torch.from_numpy(obs))
  for name in ("loc", "scale", "low", "high"):
    assert_close(getattr(td, name), getattr(jd, name), RTOL, ATOL, name)
  assert td.event_ndims == jd.event_ndims == 1
  assert tuple(td.loc.shape) == (B, act_dims)
  assert_close(td.mode(), jd.mode(), RTOL, ATOL)


def test_actor_log_std_clamp_matches_flax():
  """Projection weights scaled by 300 push the log-stds past both clamps,
  [-20, 2]; both sides clamp the same rows to the same values. The scaled
  weights make the Dense's rounding 300 times larger too, so the unclamped
  values compare at rtol 1e-4."""
  jnet, params, tnet = _actors((16, 8))
  head = params["params"]["TanhNormalProjection_0"]["Dense_0"]
  head["kernel"] = np.asarray(head["kernel"]) * 300.0
  tnet.load_state_dict(convert.sac_actor_params_to_state_dict(params))
  obs = _obs(1)
  jd, _ = jnet.apply(params, jnp.asarray(obs))
  with torch.no_grad():
    td, _ = tnet(torch.from_numpy(obs))
  log_std = torch.log(td.scale).numpy()
  clamped = (log_std <= -19.999) | (log_std >= 1.999)
  assert (log_std <= -19.999).any() and (log_std >= 1.999).any()
  assert_equal(td.scale.numpy()[clamped], np.asarray(jd.scale)[clamped])
  assert_close(td.scale, jd.scale, 1e-4, 1e-12)
  assert_close(td.loc, jd.loc, 1e-4, 1e-4)


@pytest.mark.parametrize("joint,obs_fc", [((16, 8), ()), ((16, 8), (8,)),
                                          ((256, 256), ())])
def test_critic_matches_flax(joint, obs_fc):
  jnet, params, tnet = _critics(joint, obs_fc)
  obs = _obs(2)
  act = np.random.RandomState(3).uniform(-2, 2, (B, 1)).astype(np.float32)
  jq, _ = jnet.apply(params, (jnp.asarray(obs), jnp.asarray(act)))
  with torch.no_grad():
    tq, _ = tnet((torch.from_numpy(obs), torch.from_numpy(act)))
  assert tuple(tq.shape) == (B,) and tq.dtype == torch.float32
  assert_close(tq, jq, RTOL, ATOL)


def test_converters_map_every_entry():
  _, params, tnet = _actors((16, 8))
  sd = convert.sac_actor_params_to_state_dict(params)
  assert list(sd) == list(tnet.state_dict())
  assert {k: tuple(v.shape) for k, v in sd.items()} == {
      "encoder.layers.0.weight": (16, 3), "encoder.layers.0.bias": (16,),
      "encoder.layers.1.weight": (8, 16), "encoder.layers.1.bias": (8,),
      "projections.0.dense.weight": (2, 8),
      "projections.0.dense.bias": (2,)}
  kernel = params["params"]["TanhNormalProjection_0"]["Dense_0"]["kernel"]
  assert_equal(sd["projections.0.dense.weight"], np.asarray(kernel).T)

  _, params, tnet = _critics((16, 8), (4,))
  sd = convert.sac_critic_params_to_state_dict(params)
  assert list(sd) == list(tnet.state_dict())
  assert {k: tuple(v.shape) for k, v in sd.items()} == {
      "layers.0.weight": (4, 3), "layers.0.bias": (4,),
      "layers.1.weight": (16, 5), "layers.1.bias": (16,),
      "layers.2.weight": (8, 16), "layers.2.bias": (8,),
      "q_head.weight": (1, 8), "q_head.bias": (1,)}
  with pytest.raises(ValueError):
    convert.sac_critic_params_to_state_dict({"params": {"Dense_1": {}}})
  with pytest.raises(ValueError):
    convert.sac_actor_params_to_state_dict(
        {"params": {"EncoderModule_0": {}, "NormalProjection_0": {}}})


def _check_truncated_normal(sample, scale, fan_in):
  target = math.sqrt(scale / fan_in)
  assert abs(sample.std() / target - 1.0) < 0.05, (sample.std(), target)
  assert np.abs(sample).max() <= 2.0 * target / TRUNC * (1 + 1e-6)
  assert abs(sample.mean()) < 0.05 * target


def test_init_distributions_match_flax():
  """Encoder Dense: variance_scaling(2.0) truncated normal; projection and
  critic hidden Dense: flax's default lecun_normal (variance_scaling(1.0));
  critic Q layer U(±0.003); every bias zero. Each is checked on the port's
  own init and on flax's, at (256, 256)."""
  jnet, jparams, _ = _actors((256, 256), seed=1)
  tactor = make_sac_actor_network(*_specs(tspec), fc_layer_params=(256, 256),
                                  device="cpu")
  _, jcritic, _ = _critics((256, 256), seed=1)
  tcritic = make_critic_network(*_specs(tspec), device="cpu")
  enc = jparams["params"]["EncoderModule_0"]["Dense_1"]["kernel"]
  head = jparams["params"]["TanhNormalProjection_0"]["Dense_0"]["kernel"]
  for sample in (np.asarray(enc),
                 tactor.encoder.layers[1].weight.detach().numpy()):
    _check_truncated_normal(sample, 2.0, 256)
  # The projection has 256 x 2 weights: a looser std bound.
  for sample in (np.asarray(head),
                 tactor.projections[0].dense.weight.detach().numpy()):
    target = math.sqrt(1.0 / 256)
    assert abs(sample.std() / target - 1.0) < 0.15
    assert np.abs(sample).max() <= 2.0 * target / TRUNC * (1 + 1e-6)
  for sample in (np.asarray(jcritic["params"]["Dense_1"]["kernel"]),
                 tcritic.layers[1].weight.detach().numpy()):
    _check_truncated_normal(sample, 1.0, 256)
  for sample in (np.asarray(jcritic["params"]["Dense_2"]["kernel"]),
                 tcritic.q_head.weight.detach().numpy()):
    assert np.abs(sample).max() <= 0.003
    assert abs(sample.std() / (0.003 / math.sqrt(3)) - 1.0) < 0.15
  for net in (tactor, tcritic):
    for name, p in net.named_parameters():
      if name.endswith("bias"):
        assert_equal(p.detach(), np.zeros(p.shape, np.float32))
  # `reset_parameters` draws the critic anew from the same distributions.
  g = torch.Generator().manual_seed(5)
  before = tcritic.layers[1].weight.detach().clone()
  tcritic.reset_parameters(g)
  after = tcritic.layers[1].weight.detach().numpy()
  assert not np.array_equal(before.numpy(), after)
  _check_truncated_normal(after, 1.0, 256)


def test_unported_heads_are_refused():
  """The default head is now `NormalProjection` and a discrete leaf gets a
  `CategoricalProjection` (both ported with PPO); what stays refused is
  what the JAX package refuses: a discrete leaf that is not a scalar."""
  from agents_tpu_torch.networks import (CategoricalProjection,
                                         NormalProjection)
  obs, act = _specs(tspec)
  net = make_actor_distribution_network(obs, act, device="cpu")
  assert isinstance(net.projections[0], NormalProjection)
  net = make_actor_distribution_network(
      obs, tspec.BoundedArraySpec((), np.int32, 0, 2), device="cpu",
      continuous_projection=TanhNormalProjection)
  assert isinstance(net.projections[0], CategoricalProjection)
  with pytest.raises(ValueError, match="scalar action spec"):
    make_actor_distribution_network(
        obs, tspec.BoundedArraySpec((3,), np.int32, 0, 2), device="cpu")
