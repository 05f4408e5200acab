"""Spec-driven encoder, MLP branch.

Port of ``agents_tpu/networks/encoding_network.py`` (`EncoderModule`) for
vector observations: the observation leaves are flattened past the batch
dim and concatenated, then pass through ReLU Dense layers whose weights are
drawn like flax's ``variance_scaling(2.0, fan_in, truncated_normal)`` with
zero biases. The conv branch is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from agents_tpu_torch.networks.network import variance_scaling_
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils


def flat_input_size(input_spec) -> int:
  """Width of the concatenated, flattened observation leaves."""
  leaves = nest_utils.flatten(input_spec, is_leaf=array_spec._is_spec)
  return int(sum(int(np.prod(s.shape)) for s in leaves))


class EncoderModule(nn.Module):
  """Flatten + concat the observation leaves, then the Dense stack.

  Args:
    input_size: width of the flattened observation.
    fc_layer_params: layer widths.
    activation: applied after every layer.
  """

  def __init__(self, input_size: int, fc_layer_params: Sequence[int],
               activation: Callable, device: torch.device,
               generator: Optional[torch.Generator] = None):
    super().__init__()
    self.activation = activation
    self.layers = nn.ModuleList()
    width = input_size
    for out in fc_layer_params:
      layer = nn.utils.skip_init(nn.Linear, width, out, device=device)
      variance_scaling_(layer.weight, 2.0, generator)
      nn.init.zeros_(layer.bias)
      self.layers.append(layer)
      width = out
    self.output_size = width

  def forward(self, observation, step_type=None, network_state=()):
    leaves = nest_utils.flatten(observation)
    flat = [x.reshape(x.shape[0], -1).float() for x in leaves]
    x = flat[0] if len(flat) == 1 else torch.cat(flat, dim=-1)
    for layer in self.layers:
      x = self.activation(layer(x))
    return x, network_state
