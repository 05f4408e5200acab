"""Port parity: Q network and weight conversion (`agents_tpu_torch.networks`,
`agents_tpu_torch.utils.convert`) against the JAX package.

Forward passes run from the JAX side's own flax params, carried across by
`convert.q_params_to_state_dict`; outputs agree to rtol 1e-5 / atol 1e-6.
The port's own initialisation is checked against the distributions the
JAX package draws from (flax variance scaling, the uniform head).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu import networks as jnetworks
from agents_tpu.specs import array_spec as jspec
from agents_tpu_torch.distributions import Categorical
from agents_tpu_torch.networks import make_q_network
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.utils import convert
from test_torch_parity_utils import assert_close, assert_equal

torch.set_num_threads(1)

_OBS = (4,)


def _jax_q(fc, seed=0):
  net = jnetworks.make_q_network(
      jspec.ArraySpec(_OBS, np.float32),
      jspec.BoundedArraySpec((), np.int32, 0, 1), fc_layer_params=fc)
  return net, net.init_params(jax.random.key(seed))


def _torch_q(fc, seed=0):
  g = torch.Generator().manual_seed(seed)
  return make_q_network(tspec.ArraySpec(_OBS, np.float32),
                        tspec.BoundedArraySpec((), np.int32, 0, 1),
                        fc_layer_params=fc, device="cpu", generator=g)


@pytest.mark.parametrize("fc", [(16, 8), (100, 50)])
def test_q_forward_matches_jax_from_converted_params(fc):
  jnet, params = _jax_q(fc)
  tnet = _torch_q(fc)
  tnet.load_state_dict(convert.q_params_to_state_dict(jax.device_get(params)))
  obs = np.random.RandomState(0).randn(32, 4).astype(np.float32)
  jq, _ = jnet.apply(params, jnp.asarray(obs))
  tq, state = tnet(torch.from_numpy(obs))
  assert state == ()
  assert tq.dtype == torch.float32 and tuple(tq.shape) == (32, 2)
  assert_close(tq.detach(), jq)
  # Greedy actions agree (argmax, first index on ties).
  assert_equal(Categorical(logits=tq.detach()).mode(), jnp.argmax(jq, -1))


def test_converter_layout_and_names():
  _, params = _jax_q((100, 50))
  sd = convert.q_params_to_state_dict(jax.device_get(params))
  assert list(sd) == list(_torch_q((100, 50)).state_dict())
  shapes = {k: tuple(v.shape) for k, v in sd.items()}
  assert shapes == {
      "encoder.layers.0.weight": (100, 4), "encoder.layers.0.bias": (100,),
      "encoder.layers.1.weight": (50, 100), "encoder.layers.1.bias": (50,),
      "q_head.weight": (2, 50), "q_head.bias": (2,)}
  kernel = np.asarray(params["params"]["EncoderModule_0"]["Dense_1"]["kernel"])
  assert_equal(sd["encoder.layers.1.weight"], kernel.T)
  bad = {"params": {"EncoderModule_0": {"Dense_1": {}}, "Dense_0": {}}}
  with pytest.raises(ValueError):
    convert.q_params_to_state_dict(bad)


def test_init_distribution_matches_flax_variance_scaling():
  """Hidden layers: truncated normal at +-2 sigma whose std is
  sqrt(2 / fan_in) (flax divides by 0.8796 before cutting); zero bias.
  Head: U(-0.03, 0.03), bias -0.2."""
  fc = (256, 256)
  tnet = _torch_q(fc, seed=1)
  _, params = _jax_q(fc, seed=1)
  jdense = params["params"]["EncoderModule_0"]["Dense_1"]["kernel"]
  w = tnet.encoder.layers[1].weight.detach().numpy()
  target_std = math.sqrt(2.0 / 256)
  cut = 2.0 * target_std / 0.87962566103423978
  for sample in (w, np.asarray(jdense)):
    assert abs(sample.std() / target_std - 1.0) < 0.03
    assert np.abs(sample).max() <= cut * (1 + 1e-6)
    assert abs(sample.mean()) < 0.05 * target_std
  for layer in tnet.encoder.layers:
    assert_equal(layer.bias.detach(), np.zeros(layer.bias.shape))
  head = tnet.q_head.weight.detach().numpy()
  assert np.abs(head).max() <= 0.03 and head.std() > 0.01
  assert_equal(tnet.q_head.bias.detach(), np.full(2, -0.2, np.float32))
  # A seeded generator gives the same net twice.
  again = _torch_q(fc, seed=1)
  for a, b in zip(tnet.parameters(), again.parameters()):
    assert torch.equal(a, b)


def test_conv_params_are_refused_not_dropped():
  """`make_q_network`'s third positional parameter is conv_layer_params:
  conv triples there build conv layers, and an fc tuple there is refused
  rather than silently building the default MLP."""
  act = tspec.BoundedArraySpec((), np.int32, 0, 1)
  with pytest.raises(ValueError, match="fc_layer_params="):
    make_q_network(tspec.ArraySpec(_OBS, np.float32), act, (100, 50),
                   device="cpu")
  net = make_q_network(tspec.ArraySpec((8, 8, 2), np.uint8), act,
                       ((4, 3, 2),), (16,), device="cpu")
  assert [tuple(c.weight.shape) for c in net.encoder.convs] == [(4, 2, 3, 3)]
  assert net.encoder.layers[0].in_features == 4 * 4 * 4
  q, _ = net(torch.zeros(3, 8, 8, 2, dtype=torch.uint8))
  assert tuple(q.shape) == (3, 2)
