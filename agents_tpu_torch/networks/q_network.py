"""Q-value networks: plain, dueling and categorical (C51).

Port of `QModule`, `DuelingQModule`, `CategoricalQModule`,
`make_q_network` and `make_categorical_q_network` of
``agents_tpu/networks/q_network.py``. The heads are drawn from
U(-0.03, 0.03); the Q and dueling heads start with a bias of -0.2, the
categorical head with 0. Heads run in the compute dtype and their output
is float32 (:48-53). Linear weights are ``[out, in]`` where flax's Dense
kernels are ``[in, out]``; `agents_tpu_torch.utils.convert` carries
weights across.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from agents_tpu_torch.networks.encoding_network import EncoderModule
from agents_tpu_torch.networks.network import (Network, cast_linear,
                                               seeded_generator,
                                               uniform_symmetric_)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device


def num_actions(action_spec) -> int:
  leaves = nest_utils.flatten(action_spec, is_leaf=array_spec._is_spec)
  if len(leaves) != 1:
    raise ValueError("Q networks require a single discrete action spec")
  spec = leaves[0]
  if not isinstance(spec, array_spec.BoundedArraySpec):
    raise ValueError("Q networks require a bounded action spec")
  return spec.num_values


def _head(width: int, out: int, bias: float, device, generator):
  layer = nn.utils.skip_init(nn.Linear, width, out, device=device)
  uniform_symmetric_(layer.weight, 0.03, generator)
  nn.init.constant_(layer.bias, bias)
  return layer


class _EncodedQ(Network):
  """An `EncoderModule` and the compute dtype its heads run in."""

  def __init__(self, input_spec, conv_layer_params, fc_layer_params,
               activation, dtype, preprocessing, device, generator):
    super().__init__(input_spec)
    self.dtype = dtype
    self.encoder = EncoderModule(
        input_spec, conv_layer_params, fc_layer_params, activation,
        dtype=dtype, preprocessing=preprocessing, device=device,
        generator=generator)


class QModule(_EncodedQ):
  """Encoder followed by one Q value per action."""

  def __init__(self, input_spec, num_actions: int, conv_layer_params=(),
               fc_layer_params: Sequence[int] = (64, 64),
               activation: Callable = F.relu,
               dtype: torch.dtype = torch.float32,
               preprocessing: Optional[Callable] = None, device="cuda",
               generator: Optional[torch.Generator] = None):
    device = resolve_device(device)
    super().__init__(input_spec, conv_layer_params, fc_layer_params,
                     activation, dtype, preprocessing, device, generator)
    self.q_head = _head(self.encoder.output_size, num_actions, -0.2, device,
                        generator)

  def forward(self, observation, step_type=None, network_state=()):
    x, network_state = self.encoder(observation, step_type, network_state)
    return cast_linear(x, self.q_head, self.dtype).float(), network_state


class DuelingQModule(_EncodedQ):
  """Dueling heads: Q = V + A - mean(A), in the compute dtype."""

  def __init__(self, input_spec, num_actions: int, conv_layer_params=(),
               fc_layer_params: Sequence[int] = (64, 64),
               activation: Callable = F.relu,
               dtype: torch.dtype = torch.float32,
               preprocessing: Optional[Callable] = None, device="cuda",
               generator: Optional[torch.Generator] = None):
    device = resolve_device(device)
    super().__init__(input_spec, conv_layer_params, fc_layer_params,
                     activation, dtype, preprocessing, device, generator)
    width = self.encoder.output_size
    self.value_head = _head(width, 1, -0.2, device, generator)
    self.advantage_head = _head(width, num_actions, -0.2, device, generator)

  def forward(self, observation, step_type=None, network_state=()):
    x, network_state = self.encoder(observation, step_type, network_state)
    v = cast_linear(x, self.value_head, self.dtype)
    a = cast_linear(x, self.advantage_head, self.dtype)
    q = v + a - a.mean(dim=-1, keepdim=True)
    return q.float(), network_state


class CategoricalQModule(_EncodedQ):
  """C51: `num_atoms` logits per action, ``[B, num_actions, num_atoms]``."""

  def __init__(self, input_spec, num_actions: int, num_atoms: int = 51,
               conv_layer_params=(),
               fc_layer_params: Sequence[int] = (64, 64),
               activation: Callable = F.relu,
               dtype: torch.dtype = torch.float32,
               preprocessing: Optional[Callable] = None, device="cuda",
               generator: Optional[torch.Generator] = None):
    device = resolve_device(device)
    super().__init__(input_spec, conv_layer_params, fc_layer_params,
                     activation, dtype, preprocessing, device, generator)
    self.num_actions = num_actions
    self.num_atoms = num_atoms
    self.q_head = _head(self.encoder.output_size, num_actions * num_atoms,
                        0.0, device, generator)

  def forward(self, observation, step_type=None, network_state=()):
    x, network_state = self.encoder(observation, step_type, network_state)
    logits = cast_linear(x, self.q_head, self.dtype)
    logits = logits.reshape(x.shape[0], self.num_actions, self.num_atoms)
    return logits.float(), network_state


def make_q_network(input_spec, action_spec, conv_layer_params=(),
                   fc_layer_params=(64, 64), activation: Callable = F.relu,
                   dueling: bool = False, dtype: torch.dtype = torch.float32,
                   preprocessing: Optional[Callable] = None, device="cuda",
                   generator: Optional[torch.Generator] = None) -> Network:
  """A `QModule` (or `DuelingQModule`) on `device`, initialised from
  `generator` (a fresh generator seeded 0 on the device when None)."""
  device = resolve_device(device)
  cls = DuelingQModule if dueling else QModule
  return cls(input_spec, num_actions(action_spec), tuple(conv_layer_params),
             tuple(fc_layer_params), activation, dtype, preprocessing,
             device, seeded_generator(device, generator))


def make_categorical_q_network(input_spec, action_spec, num_atoms: int = 51,
                               conv_layer_params=(), fc_layer_params=(64, 64),
                               activation: Callable = F.relu,
                               dtype: torch.dtype = torch.float32,
                               preprocessing: Optional[Callable] = None,
                               device="cuda",
                               generator: Optional[torch.Generator] = None,
                               ) -> CategoricalQModule:
  """A `CategoricalQModule` on `device` (its `num_atoms` attribute set).

  `preprocessing` goes to the encoder as in `make_q_network`; the JAX
  factory does not take it (its module does), so leave it None to build
  the JAX factory's network.
  """
  device = resolve_device(device)
  return CategoricalQModule(
      input_spec, num_actions(action_spec), num_atoms,
      tuple(conv_layer_params), tuple(fc_layer_params), activation, dtype,
      preprocessing, device, seeded_generator(device, generator))
