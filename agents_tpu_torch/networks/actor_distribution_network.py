"""Actor networks: observation -> a nest of distributions.

Port of `ActorDistributionModule`, `make_actor_distribution_network` and
`make_sac_actor_network` of
``agents_tpu/networks/actor_distribution_network.py`` (:23-49, :72-98),
continuous branch: an `EncoderModule` (variance_scaling(2.0) Dense stack),
then one projection head per leaf of the action spec nest. The output is
the action spec nest with each spec replaced by its distribution.

The JAX factory's default head, `NormalProjection`, and the categorical
head of discrete leaves are not ported yet, so the port's factory takes
its `continuous_projection` explicitly and refuses discrete leaves.
`DeterministicActorModule` (DDPG, TD3) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from agents_tpu_torch.networks.encoding_network import EncoderModule
from agents_tpu_torch.networks.network import Network, seeded_generator
from agents_tpu_torch.networks.projection_networks import TanhNormalProjection
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device


class ActorDistributionModule(Network):
  """Encoder, then `continuous_projection` per action-spec leaf.

  Args:
    input_spec: the observation spec nest.
    action_spec: a nest of continuous BoundedArraySpecs.
    continuous_projection: the head class, built as
      ``continuous_projection(width, spec, dtype=, device=, generator=)``.
  """

  def __init__(self, input_spec, action_spec, continuous_projection,
               conv_layer_params=(),
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
      if not array_spec.is_continuous(spec):
        raise NotImplementedError(
            f"the categorical projection is not ported yet; got {spec}")
      self.projections.append(continuous_projection(
          self.encoder.output_size, spec, dtype=dtype, device=device,
          generator=generator))

  def forward(self, observation, step_type=None, network_state=()):
    x, network_state = self.encoder(observation, step_type, network_state)
    dists = iter([projection(x) for projection in self.projections])
    return nest_utils.tree_map(lambda _: next(dists), self.action_spec,
                               is_leaf=array_spec._is_spec), network_state


def make_actor_distribution_network(
    input_spec, action_spec, conv_layer_params=(), fc_layer_params=(200, 100),
    activation: Callable = F.relu, continuous_projection=None,
    dtype: torch.dtype = torch.float32, device="cuda",
    generator: Optional[torch.Generator] = None) -> ActorDistributionModule:
  """An `ActorDistributionModule` on `device`, initialised from `generator`
  (a fresh generator seeded 0 on the device when None). The JAX default
  head, `NormalProjection`, is not ported yet: pass
  ``continuous_projection=TanhNormalProjection``."""
  if continuous_projection is None:
    raise NotImplementedError(
        "NormalProjection (the JAX factory's default head) is not ported "
        "yet; pass continuous_projection=TanhNormalProjection")
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
