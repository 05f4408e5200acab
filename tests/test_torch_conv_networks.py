"""Port parity: the conv encoder and the dueling and categorical Q networks
(`agents_tpu_torch.networks`, `agents_tpu_torch.utils.convert`) against
the JAX package.

Forward passes start from the JAX side's own flax init, carried across
by `convert.q_params_to_state_dict`. Float32 outputs agree to rtol 1e-5 /
atol 1e-5; bfloat16 outputs (float32 params cast at use, as flax's
``dtype=bfloat16``) to atol 1e-2, with greedy actions equal wherever the
top two Q values differ by more than 1e-2.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu import networks as jnetworks
from agents_tpu.specs import array_spec as jspec
from agents_tpu_torch.networks import (make_categorical_q_network,
                                       make_q_network)
from agents_tpu_torch.networks.encoding_network import same_padding
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.utils import convert
from test_torch_parity_utils import assert_close, assert_equal

torch.set_num_threads(1)

OBS, NUM_ACTIONS = (12, 12, 4), 4
CONV, FC = ((8, 3, 2), (16, 3, 2)), (32,)
MNIH15 = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
RTOL = ATOL = 1e-5


def _jspecs(obs=OBS):
  return (jspec.BoundedArraySpec(obs, np.uint8, 0, 255),
          jspec.BoundedArraySpec((), np.int32, 0, NUM_ACTIONS - 1))


def _tspecs(obs=OBS):
  return (tspec.BoundedArraySpec(obs, np.uint8, 0, 255),
          tspec.BoundedArraySpec((), np.int32, 0, NUM_ACTIONS - 1))


def _frames(n=16, obs=OBS, seed=0):
  return np.random.RandomState(seed).randint(0, 256, (n,) + obs).astype(
      np.uint8)


def _pair(kind="q", dtype="float32", scale=True, conv=CONV, fc=FC,
          obs=OBS, seed=0):
  """(JAX net, its params, port net loaded with them)."""
  jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
  jpre = (lambda x: x.astype(jdtype) / 255.0) if scale else None
  tpre = (lambda x: x.to(tdtype) / 255.0) if scale else None
  jobs, jact = _jspecs(obs)
  tobs, tact = _tspecs(obs)
  if kind == "categorical":
    jnet = jnetworks.make_categorical_q_network(
        jobs, jact, num_atoms=5, conv_layer_params=conv, fc_layer_params=fc,
        dtype=jdtype)
    tnet = make_categorical_q_network(
        tobs, tact, num_atoms=5, conv_layer_params=conv, fc_layer_params=fc,
        dtype=tdtype, device="cpu")
  else:
    jnet = jnetworks.make_q_network(
        jobs, jact, conv_layer_params=conv, fc_layer_params=fc,
        dueling=kind == "dueling", dtype=jdtype, preprocessing=jpre)
    tnet = make_q_network(tobs, tact, conv_layer_params=conv,
                          fc_layer_params=fc, dueling=kind == "dueling",
                          dtype=tdtype, preprocessing=tpre, device="cpu")
  params = jax.device_get(jnet.init_params(jax.random.key(seed)))
  tnet.load_state_dict(convert.q_params_to_state_dict(params))
  return jnet, params, tnet


def _forward(jnet, params, tnet, frames):
  jq, _ = jnet.apply(params, jnp.asarray(frames))
  with torch.no_grad():
    tq, state = tnet(torch.from_numpy(frames))
  assert state == ()
  return np.asarray(jq), tq


@pytest.mark.parametrize("scale", [True, False], ids=["div255", "raw"])
def test_conv_q_forward_matches_jax_fp32(scale):
  """Raw uint8 becomes 0-255 floats without preprocessing, as
  `tests/test_conv_path.py` relies on."""
  jnet, params, tnet = _pair(scale=scale)
  jq, tq = _forward(jnet, params, tnet, _frames())
  assert tq.dtype == torch.float32 and tuple(tq.shape) == (16, NUM_ACTIONS)
  assert_close(tq, jq, rtol=RTOL, atol=ATOL)
  assert_equal(tq.argmax(-1), jq.argmax(-1))


def test_conv_q_forward_matches_jax_bf16():
  jnet, params, tnet = _pair(dtype="bfloat16")
  jq, tq = _forward(jnet, params, tnet, _frames(64))
  assert tq.dtype == torch.float32
  assert all(p.dtype == torch.float32 for p in tnet.parameters())
  assert_close(tq, jq, rtol=0.0, atol=1e-2)
  top2 = np.sort(jq, -1)[:, -2:]
  clear = (top2[:, 1] - top2[:, 0]) > 1e-2
  assert clear.sum() >= 32
  assert_equal(tq.argmax(-1).numpy()[clear], jq.argmax(-1)[clear])


@pytest.mark.parametrize("kind", ["dueling", "categorical"])
def test_dueling_and_categorical_heads_match_jax(kind):
  jnet, params, tnet = _pair(kind=kind)
  jout, tout = _forward(jnet, params, tnet, _frames())
  shape = (16, NUM_ACTIONS) if kind == "dueling" else (16, NUM_ACTIONS, 5)
  assert tuple(tout.shape) == shape and tout.dtype == torch.float32
  assert_close(tout, jout, rtol=RTOL, atol=ATOL)
  if kind == "categorical":
    assert tnet.num_atoms == 5


@pytest.mark.parametrize("size,kernel,stride", [
    (84, 8, 4), (21, 4, 2), (11, 3, 1), (7, 3, 2), (13, 5, 3), (5, 6, 2),
    (9, 1, 4)])
def test_same_padding_matches_xla(size, kernel, stride):
  """A one-layer conv at odd sizes and strides above 1 gives XLA's SAME
  output shape and values."""
  obs = (size, size + 2, 3)
  conv = ((4, kernel, stride),)
  _, params, tnet = _pair(conv=conv, fc=(), obs=obs)
  frames = _frames(4, obs)
  kernel_hwio = params["params"]["EncoderModule_0"]["Conv_0"]["kernel"]
  bias = params["params"]["EncoderModule_0"]["Conv_0"]["bias"]
  x = frames.astype(np.float32) / 255.0
  expect = jax.lax.conv_general_dilated(
      jnp.asarray(x), jnp.asarray(kernel_hwio), (stride, stride), "SAME",
      dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
  expect = np.maximum(np.asarray(expect), 0.0)
  with torch.no_grad():
    got = tnet.encoder._conv_stack(torch.from_numpy(x),
                                   tnet.encoder._conv_plans[0])
  assert tuple(got.shape) == expect.shape == (
      4, -(-size // stride), -(-(size + 2) // stride), 4)
  assert_close(got, expect, rtol=RTOL, atol=ATOL)


def test_mnih15_pads_on_84():
  pads, size = [], 84
  for _, kernel, stride in MNIH15:
    pads.append(same_padding(size, kernel, stride))
    size = -(-size // stride)
  assert pads == [(2, 2), (1, 2), (1, 1)] and size == 11


@pytest.mark.parametrize("kind", ["q", "dueling", "categorical"])
def test_converter_names_and_shapes(kind):
  _, params, tnet = _pair(kind=kind)
  sd = convert.q_params_to_state_dict(params)
  assert list(sd) == list(tnet.state_dict())
  heads = {"q": {"q_head.weight": (4, 32), "q_head.bias": (4,)},
           "dueling": {"value_head.weight": (1, 32), "value_head.bias": (1,),
                       "advantage_head.weight": (4, 32),
                       "advantage_head.bias": (4,)},
           "categorical": {"q_head.weight": (20, 32),
                           "q_head.bias": (20,)}}[kind]
  assert {k: tuple(v.shape) for k, v in sd.items()} == {
      "encoder.convs.0.weight": (8, 4, 3, 3), "encoder.convs.0.bias": (8,),
      "encoder.convs.1.weight": (16, 8, 3, 3), "encoder.convs.1.bias": (16,),
      "encoder.layers.0.weight": (32, 3 * 3 * 16),
      "encoder.layers.0.bias": (32,), **heads}
  kernel = np.asarray(params["params"]["EncoderModule_0"]["Conv_1"]["kernel"])
  assert_equal(sd["encoder.convs.1.weight"], kernel.transpose(3, 2, 0, 1))
  if kind == "dueling":
    assert_equal(sd["value_head.bias"], params["params"]["Dense_0"]["bias"])
    assert_equal(sd["advantage_head.weight"],
                 np.asarray(params["params"]["Dense_1"]["kernel"]).T)
  bad = {"params": {**params["params"], "Dense_2": {}}}
  with pytest.raises(ValueError, match="head"):
    convert.q_params_to_state_dict(bad)
  encoder = dict(params["params"]["EncoderModule_0"], Conv_7={})
  with pytest.raises(ValueError, match="encoder"):
    convert.q_params_to_state_dict(
        {"params": {**params["params"], "EncoderModule_0": encoder}})


def test_conv_kernel_init_std_matches_flax():
  """The conv kernels' truncated normal has std sqrt(2 / (kh*kw*I)), the
  fan-in of flax's HWIO kernel, on both sides; conv biases start at 0."""
  obs = (44, 44, 4)
  _, params, _ = _pair(conv=MNIH15, fc=(), obs=obs)
  tnet = make_q_network(*_tspecs(obs), conv_layer_params=MNIH15,
                        fc_layer_params=(), device="cpu",
                        generator=torch.Generator().manual_seed(1))
  cin = 4
  for i, (filters, kernel, _) in enumerate(MNIH15):
    target_std = math.sqrt(2.0 / (kernel * kernel * cin))
    cut = 2.0 * target_std / 0.87962566103423978
    jkernel = np.asarray(params["params"]["EncoderModule_0"][f"Conv_{i}"][
        "kernel"])
    tweight = tnet.encoder.convs[i].weight.detach().numpy()
    assert tweight.shape == (filters, cin, kernel, kernel)
    for sample in (tweight, jkernel):
      assert abs(sample.std() / target_std - 1.0) < 0.05, i
      assert np.abs(sample).max() <= cut * (1 + 1e-6)
    assert_equal(tnet.encoder.convs[i].bias.detach(), np.zeros(filters))
    cin = filters


def test_bf16_gradients_reach_fp32_params():
  _, _, tnet = _pair(dtype="bfloat16")
  q, _ = tnet(torch.from_numpy(_frames(8)))
  q.sum().backward()
  for name, p in tnet.named_parameters():
    assert p.dtype == torch.float32 and p.grad is not None, name
    assert p.grad.dtype == torch.float32 and bool(p.grad.abs().sum() > 0)


def test_conv_refuses_leaves_it_cannot_take():
  tact = _tspecs()[1]
  with pytest.raises(ValueError, match=r"\[H, W, C\]"):
    make_q_network(tspec.ArraySpec((12, 12), np.uint8), tact,
                   conv_layer_params=CONV, device="cpu")
  with pytest.raises(ValueError, match="no observation leaf"):
    make_q_network(tspec.ArraySpec((4,), np.float32), tact,
                   conv_layer_params=CONV, device="cpu")
  # A vector leaf beside an image leaf is only flattened, as in flax.
  net = make_q_network((tspec.ArraySpec(OBS, np.uint8),
                        tspec.ArraySpec((3,), np.float32)), tact,
                       conv_layer_params=CONV, fc_layer_params=FC,
                       device="cpu")
  assert net.encoder.layers[0].in_features == 3 * 3 * 16 + 3
  q, _ = net((torch.from_numpy(_frames(2)), torch.ones(2, 3)))
  assert tuple(q.shape) == (2, NUM_ACTIONS)
