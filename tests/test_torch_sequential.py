"""Port parity: the network combinators (`agents_tpu_torch.networks.
sequential`) against the JAX package's `networks/sequential.py`.

A chain of a dense layer, a ReLU, a bias layer and an inner reshape, and
a nest map of two dense layers, run on the same weights (flax kernels
``[in, out]`` set as Linear weights ``[out, in]``) and inputs; outputs
agree to rtol 1e-5 / atol 1e-6, and the chain's state tuple has one entry
per layer on both sides.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from agents_tpu.networks import sequential as jseq
from agents_tpu.specs import array_spec as jspec
from agents_tpu_torch.networks import (BiasLayer, NestMapModule,
                                       SequentialModule, inner_reshape,
                                       mask_splitter, sequential)
from agents_tpu_torch.specs import array_spec as tspec
from test_torch_parity_utils import assert_close

torch.set_num_threads(1)


def _linear(dense_params):
  kernel = np.asarray(dense_params["kernel"])
  layer = nn.Linear(*kernel.shape)
  with torch.no_grad():
    layer.weight.copy_(torch.from_numpy(kernel.T.copy()))
    layer.bias.copy_(torch.from_numpy(np.array(dense_params["bias"])))
  return layer


def test_sequential_chain_matches_jax():
  jnet = jseq.sequential(
      [fnn.Dense(4), lambda x: jax.nn.relu(x), jseq.BiasLayer(),
       jseq.inner_reshape((2, 2))], jspec.ArraySpec((3,), np.float32))
  params = jax.device_get(jnet.init_params(jax.random.key(0)))["params"]
  params["layers_2"]["bias"] = np.arange(4, dtype=np.float32) - 1.5
  bias = BiasLayer(4, device="cpu")
  with torch.no_grad():
    bias.bias.copy_(torch.from_numpy(params["layers_2"]["bias"]))
  # A builtin has no signature to read, so both chains would call it with
  # the full convention: the ReLU is wrapped in a one-argument function.
  tnet = sequential([_linear(params["layers_0"]), lambda x: torch.relu(x),
                     bias, inner_reshape((2, 2))],
                    tspec.ArraySpec((3,), np.float32))
  x = np.random.RandomState(1).randn(5, 3).astype(np.float32)
  jout, jstate = jnet.apply({"params": params}, jnp.asarray(x), None, ())
  tout, tstate = tnet(torch.from_numpy(x))
  assert tuple(tout.shape) == (5, 2, 2)
  assert_close(tout, jout)
  assert tstate == jstate == ((), (), (), ())
  assert len(list(tnet.parameters())) == 3
  assert tnet.input_spec == tspec.ArraySpec((3,), np.float32)


class _Counter(nn.Module):
  """A stateful layer: adds its state and counts its calls in it."""

  def forward(self, x, step_type, state):
    state = torch.zeros(()) if isinstance(state, tuple) else state
    return x + state, state + 1


class _Raises(nn.Module):

  def forward(self, x, step_type, state):
    raise TypeError("inside the layer")


def test_sequential_threads_each_layers_state_and_lets_errors_through():
  net = SequentialModule([_Counter(), lambda x: 2 * x, _Counter()])
  out, state = net(torch.ones(2), None, ())
  assert torch.equal(out, torch.full((2,), 2.0))
  assert [float(s) if isinstance(s, torch.Tensor) else s for s in state] == [
      1.0, (), 1.0]
  out, state = net(torch.ones(2), None, state)
  assert torch.equal(out, torch.full((2,), 5.0))
  assert float(state[0]) == 2.0 and float(state[2]) == 2.0
  with pytest.raises(TypeError, match="inside the layer"):
    SequentialModule([_Raises()])(torch.ones(2))


def test_nest_map_matches_jax():
  jmod = jseq.NestMapModule((fnn.Dense(2), fnn.Dense(3)))
  xs = (np.random.RandomState(2).randn(4, 4).astype(np.float32),
        np.random.RandomState(3).randn(4, 5).astype(np.float32))
  params = jax.device_get(jmod.init(jax.random.key(1), tuple(
      jnp.asarray(x) for x in xs)))["params"]
  tmod = NestMapModule((_linear(params["modules_0"]),
                        _linear(params["modules_1"])))
  jout, _ = jmod.apply({"params": params}, tuple(jnp.asarray(x) for x in xs))
  tout, state = tmod(tuple(torch.from_numpy(x) for x in xs))
  for t, j in zip(tout, jout):
    assert_close(t, j)
  assert state == () and len(list(tmod.parameters())) == 4
  dict_map = NestMapModule({"b": nn.Identity(), "a": nn.Flatten()})
  out, _ = dict_map({"a": torch.ones(2, 3, 2), "b": torch.ones(2)})
  assert tuple(out["a"].shape) == (2, 6) and tuple(out["b"].shape) == (2,)


def test_inner_reshape_keeps_outer_dims_and_splitter_passes_through():
  assert tuple(inner_reshape((4, 4))(torch.zeros(2, 5, 16)).shape) == (
      2, 5, 4, 4)
  assert tuple(inner_reshape((16,))(torch.zeros(3, 16)).shape) == (3, 16)
  assert tuple(inner_reshape((3, 2), inner_rank=2)(
      torch.zeros(7, 2, 3)).shape) == (7, 3, 2)
  split = mask_splitter(lambda obs: (obs[..., :2], obs[..., 2:] > 0))
  obs, mask = split(torch.tensor([[1.0, 2.0, 1.0, -1.0]]))
  assert tuple(obs.shape) == (1, 2) and mask.tolist() == [[True, False]]
