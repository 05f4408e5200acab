"""Q-value network.

Port of `QModule` and `make_q_network` of
``agents_tpu/networks/q_network.py`` (MLP encoder). The last layer is drawn
from U(-0.03, 0.03) with a bias of -0.2, and its output is float32, as in
the JAX package (:48-53). Linear weights are ``[out, in]`` where flax's
Dense kernels are ``[in, out]``; `agents_tpu_torch.utils.convert` carries
weights across.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from agents_tpu_torch.networks.encoding_network import (EncoderModule,
                                                        flat_input_size)
from agents_tpu_torch.networks.network import Network, uniform_symmetric_
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


class QModule(Network):
  """Encoder MLP followed by one Q value per action."""

  def __init__(self, input_spec, num_actions: int,
               fc_layer_params: Sequence[int] = (64, 64),
               activation: Callable = F.relu, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__(input_spec)
    device = resolve_device(device)
    self.encoder = EncoderModule(flat_input_size(input_spec), fc_layer_params,
                                 activation, device, generator)
    self.q_head = nn.utils.skip_init(nn.Linear, self.encoder.output_size,
                                     num_actions, device=device)
    uniform_symmetric_(self.q_head.weight, 0.03, generator)
    nn.init.constant_(self.q_head.bias, -0.2)

  def forward(self, observation, step_type=None, network_state=()):
    x, network_state = self.encoder(observation, step_type, network_state)
    return self.q_head(x).float(), network_state


def make_q_network(input_spec, action_spec, conv_layer_params=(),
                   fc_layer_params=(64, 64), activation: Callable = F.relu,
                   device="cuda", generator: Optional[torch.Generator] = None,
                   ) -> QModule:
  """A `QModule` on `device`, initialised from `generator` (a fresh
  generator seeded 0 on the device when None)."""
  if conv_layer_params:
    raise NotImplementedError(
        "the conv encoder is not ported yet; only fc_layer_params is")
  device = resolve_device(device)
  if generator is None:
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
  return QModule(input_spec, num_actions(action_spec),
                 tuple(fc_layer_params), activation, device, generator)
