"""Actor networks: observation -> a nest of distributions.

Port of `ActorDistributionModule`, `make_actor_distribution_network` and
`make_sac_actor_network` of
``agents_tpu/networks/actor_distribution_network.py`` (:23-49, :76-98):
an `EncoderModule` (variance_scaling(2.0) Dense stack), then one head per
leaf of the action spec nest, chosen by `default_projection`: a
`CategoricalProjection` for a discrete leaf, `continuous_projection`
(`NormalProjection` by default) for a continuous one. The output is the
action spec nest with each spec replaced by its distribution.

`DeterministicActorModule` and `make_deterministic_actor_network`
(:52-73, :101-111), the DDPG and TD3 actor: the encoder, a Dense to
``prod(spec.shape)`` with a U(±0.003) kernel and zero bias, `tanh` in
float32, a reshape to the spec's shape, and the affine map
``low + (high - low) / 2 * (a + 1)`` into the bounds of the one action
spec.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from agents_tpu_torch.networks.encoding_network import EncoderModule
from agents_tpu_torch.networks.network import (Network, cast_linear,
                                               seeded_generator,
                                               uniform_symmetric_,
                                               variance_scaling_)
from agents_tpu_torch.networks.projection_networks import (
    NormalProjection, TanhNormalProjection, default_projection)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device


class ActorDistributionModule(Network):
  """Encoder, then one `default_projection` head per action-spec leaf.

  Args:
    input_spec: the observation spec nest.
    action_spec: a nest of BoundedArraySpecs.
    continuous_projection: the head of continuous leaves, built as
      ``continuous_projection(width, spec, dtype=, device=, generator=)``.
  """

  def __init__(self, input_spec, action_spec,
               continuous_projection=NormalProjection, conv_layer_params=(),
               fc_layer_params: Sequence[int] = (200, 100),
               activation: Callable = F.relu,
               dtype: torch.dtype = torch.float32, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__(input_spec)
    device = resolve_device(device)
    self.action_spec = action_spec
    self.encoder = EncoderModule(input_spec, conv_layer_params,
                                 fc_layer_params, activation, dtype=dtype,
                                 device=device, generator=generator)
    self.projections = nn.ModuleList()
    for spec in nest_utils.flatten(action_spec, is_leaf=array_spec._is_spec):
      self.projections.append(default_projection(
          self.encoder.output_size, spec, continuous_projection, dtype=dtype,
          device=device, generator=generator))

  def forward(self, observation, step_type=None, network_state=()):
    x, network_state = self.encoder(observation, step_type, network_state)
    dists = iter([projection(x) for projection in self.projections])
    return nest_utils.tree_map(lambda _: next(dists), self.action_spec,
                               is_leaf=array_spec._is_spec), network_state


def make_actor_distribution_network(
    input_spec, action_spec, conv_layer_params=(), fc_layer_params=(200, 100),
    activation: Callable = F.relu, continuous_projection=NormalProjection,
    dtype: torch.dtype = torch.float32, device="cuda",
    generator: Optional[torch.Generator] = None) -> ActorDistributionModule:
  """An `ActorDistributionModule` on `device`, initialised from `generator`
  (a fresh generator seeded 0 on the device when None)."""
  device = resolve_device(device)
  return ActorDistributionModule(
      input_spec, action_spec, continuous_projection,
      tuple(conv_layer_params), tuple(fc_layer_params), activation, dtype,
      device, seeded_generator(device, generator))


def make_sac_actor_network(input_spec, action_spec,
                           fc_layer_params=(256, 256),
                           activation: Callable = F.relu,
                           dtype: torch.dtype = torch.float32, device="cuda",
                           generator: Optional[torch.Generator] = None
                           ) -> ActorDistributionModule:
  """The SAC actor: `TanhNormalProjection` heads."""
  return make_actor_distribution_network(
      input_spec, action_spec, fc_layer_params=fc_layer_params,
      activation=activation, continuous_projection=TanhNormalProjection,
      dtype=dtype, device=device, generator=generator)


class DeterministicActorModule(Network):
  """observation -> a tanh-squashed action within `action_spec`'s bounds.

  Args:
    input_spec: the observation spec nest.
    action_spec: one continuous BoundedArraySpec.
  """

  def __init__(self, input_spec, action_spec,
               fc_layer_params: Sequence[int] = (256, 256),
               activation: Callable = F.relu,
               dtype: torch.dtype = torch.float32, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__(input_spec)
    device = resolve_device(device)
    self.action_spec = action_spec
    self.dtype = dtype
    self.encoder = EncoderModule(input_spec, (), fc_layer_params, activation,
                                 dtype=dtype, device=device,
                                 generator=generator)
    self.action_head = nn.utils.skip_init(
        nn.Linear, self.encoder.output_size, math.prod(action_spec.shape),
        device=device)
    self._reset_action_head(generator)
    low = np.broadcast_to(action_spec.minimum, action_spec.shape)
    high = np.broadcast_to(action_spec.maximum, action_spec.shape)
    # One bound over the whole spec maps with Python floats: no tensor to
    # copy to the device at each call.
    if np.all(low == low.flat[0]) and np.all(high == high.flat[0]):
      self._low, self._high = float(low.flat[0]), float(high.flat[0])
    else:
      for name, bound in (("_low", low), ("_high", high)):
        self.register_buffer(name, torch.tensor(
            bound, dtype=torch.float32, device=device), persistent=False)

  def _reset_action_head(self, generator):
    uniform_symmetric_(self.action_head.weight, 0.003, generator)
    nn.init.zeros_(self.action_head.bias)

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    """Draw every weight anew from `generator`: the encoder's
    variance_scaling(2) layers, a U(±0.003) action layer, zero biases."""
    for layer in self.encoder.layers:
      variance_scaling_(layer.weight, 2.0, generator)
      nn.init.zeros_(layer.bias)
    self._reset_action_head(generator)

  def forward(self, observation, step_type=None, network_state=()):
    x, network_state = self.encoder(observation, step_type, network_state)
    a = torch.tanh(cast_linear(x, self.action_head, self.dtype).float())
    a = a.reshape(a.shape[:-1] + tuple(self.action_spec.shape))
    return (self._low + (self._high - self._low) / 2.0 * (a + 1.0),
            network_state)


def make_deterministic_actor_network(
    input_spec, action_spec, fc_layer_params=(256, 256),
    activation: Callable = F.relu, dtype: torch.dtype = torch.float32,
    device="cuda", generator: Optional[torch.Generator] = None
) -> DeterministicActorModule:
  """A `DeterministicActorModule` on `device`, initialised from `generator`
  (a fresh generator seeded 0 on the device when None)."""
  device = resolve_device(device)
  return DeterministicActorModule(input_spec, action_spec,
                                  tuple(fc_layer_params), activation, dtype,
                                  device, seeded_generator(device, generator))
