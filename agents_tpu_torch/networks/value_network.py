"""The state-value network V(s) and the critic network Q(s, a).

Port of ``agents_tpu/networks/value_network.py``. `ValueModule` and
`make_value_network` (:20-35, :75-82): an `EncoderModule`, then a Dense
with a U(±0.03) kernel and zero bias to one value per row, ``[B]``
float32; `activation` is the encoder's (the schulman17 nets use tanh).

`CriticModule` and `make_critic_network` (:38-94): the observation leaves
are flattened past the batch dim and concatenated, pass the optional
`observation_fc_layer_params` layers, are joined with the flattened
action leaves, pass the `joint_fc_layer_params` layers, and a last Dense
gives one Q value per row, ``[B]`` float32. The hidden layers take flax's
default Dense init (`lecun_normal_`, zero bias), the last layer U(±0.003)
with zero bias. `layers` holds the observation layers first, then the
joint layers, in flax's ``Dense_i`` order.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from agents_tpu_torch.networks.encoding_network import EncoderModule
from agents_tpu_torch.networks.network import (Network, cast_linear,
                                               lecun_normal_,
                                               seeded_generator,
                                               uniform_symmetric_)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device


def _width(spec_nest) -> int:
  return sum(math.prod(s.shape) for s in nest_utils.flatten(
      spec_nest, is_leaf=array_spec._is_spec))


def _flat(nest, dtype):
  """The leaves of `nest`, each flattened past the batch dim."""
  return [x.reshape(x.shape[0], -1).to(dtype)
          for x in nest_utils.flatten(nest)]


class ValueModule(Network):
  """V(observation) -> [B]."""

  def __init__(self, input_spec, fc_layer_params: Sequence[int] = (64, 64),
               conv_layer_params=(), activation: Callable = F.relu,
               dtype: torch.dtype = torch.float32, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__(input_spec)
    device = resolve_device(device)
    self.dtype = dtype
    self.encoder = EncoderModule(input_spec, conv_layer_params,
                                 fc_layer_params, activation, dtype=dtype,
                                 device=device, generator=generator)
    self.value_head = nn.utils.skip_init(nn.Linear, self.encoder.output_size,
                                         1, device=device)
    uniform_symmetric_(self.value_head.weight, 0.03, generator)
    nn.init.zeros_(self.value_head.bias)

  def forward(self, observation, step_type=None, network_state=()):
    x, network_state = self.encoder(observation, step_type, network_state)
    v = cast_linear(x, self.value_head, self.dtype)
    return v.squeeze(-1).float(), network_state


def make_value_network(input_spec, fc_layer_params=(64, 64),
                       conv_layer_params=(), activation: Callable = F.relu,
                       dtype: torch.dtype = torch.float32, device="cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> ValueModule:
  """A `ValueModule` on `device`, initialised from `generator` (a fresh
  generator seeded 0 on the device when None)."""
  device = resolve_device(device)
  return ValueModule(input_spec, tuple(fc_layer_params),
                     tuple(conv_layer_params), activation, dtype, device,
                     seeded_generator(device, generator))


class CriticModule(Network):
  """Q(observation, action) -> [B].

  Args:
    input_spec: ``(observation_spec, action_spec)``.
  """

  def __init__(self, input_spec, observation_fc_layer_params=(),
               joint_fc_layer_params: Sequence[int] = (256, 256),
               activation: Callable = F.relu,
               dtype: torch.dtype = torch.float32, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__(input_spec)
    device = resolve_device(device)
    observation_spec, action_spec = input_spec
    self.activation = activation
    self.dtype = dtype
    self.num_observation_layers = len(observation_fc_layer_params)
    self.layers = nn.ModuleList()
    width = _width(observation_spec)
    for i, out in enumerate(tuple(observation_fc_layer_params)
                            + tuple(joint_fc_layer_params)):
      if i == self.num_observation_layers:
        width += _width(action_spec)
      self.layers.append(nn.utils.skip_init(nn.Linear, width, out,
                                            device=device))
      width = out
    if not joint_fc_layer_params:
      width += _width(action_spec)
    self.q_head = nn.utils.skip_init(nn.Linear, width, 1, device=device)
    self.reset_parameters(generator)

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    """Draw every weight from `generator`: `lecun_normal_` hidden layers,
    a U(±0.003) Q layer, zero biases."""
    for layer in self.layers:
      lecun_normal_(layer.weight, generator=generator)
      nn.init.zeros_(layer.bias)
    uniform_symmetric_(self.q_head.weight, 0.003, generator)
    nn.init.zeros_(self.q_head.bias)

  def _apply_layers(self, x, layers):
    for layer in layers:
      x = self.activation(cast_linear(x, layer, self.dtype))
    return x

  def forward(self, observation_and_action, step_type=None, network_state=()):
    observation, action = observation_and_action
    obs = _flat(observation, self.dtype)
    x = obs[0] if len(obs) == 1 else torch.cat(obs, dim=-1)
    n = self.num_observation_layers
    x = self._apply_layers(x, self.layers[:n])
    x = torch.cat([x] + _flat(action, self.dtype), dim=-1)
    x = self._apply_layers(x, self.layers[n:])
    q = cast_linear(x, self.q_head, self.dtype)
    return q.squeeze(-1).float(), network_state


def make_critic_network(observation_spec, action_spec,
                        observation_fc_layer_params=(),
                        joint_fc_layer_params=(256, 256),
                        activation: Callable = F.relu,
                        dtype: torch.dtype = torch.float32, device="cuda",
                        generator: Optional[torch.Generator] = None
                        ) -> CriticModule:
  """A `CriticModule` on `device`, initialised from `generator` (a fresh
  generator seeded 0 on the device when None)."""
  device = resolve_device(device)
  return CriticModule((observation_spec, action_spec),
                      tuple(observation_fc_layer_params),
                      tuple(joint_fc_layer_params), activation, dtype, device,
                      seeded_generator(device, generator))
