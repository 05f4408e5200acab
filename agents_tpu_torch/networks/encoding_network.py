"""Spec-driven encoder: preprocessing -> conv -> MLP.

Port of ``agents_tpu/networks/encoding_network.py`` (`EncoderModule`).
For each observation leaf, in order: the optional `preprocessing`, a cast
to the compute dtype, the conv stack if the leaf is an image
``[B, H, W, C]``, and a flatten past the batch dim. The leaves are then
concatenated and pass through the ReLU Dense stack.

Layouts follow flax, so converted weights apply unchanged:
  - the observation stays NHWC; ``permute(0, 3, 1, 2)`` views it as NCHW
    in channels-last memory, which cuDNN takes without a copy;
  - each conv pads as XLA's SAME does (`same_padding`): torch's
    ``padding="same"`` refuses stride > 1;
  - the conv output is flattened in NHWC order, the order flax's first
    Dense kernel expects.

Weights are drawn like flax's ``variance_scaling(2.0, fan_in,
truncated_normal)`` with zero biases. Parameters are float32 and are cast
to the compute `dtype` at each use (flax's ``dtype=`` with the default
``param_dtype``): activations stay in that dtype, and gradients reach the
float32 parameters through the casts.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from agents_tpu_torch.networks.network import cast_linear, variance_scaling_
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
  """(low, high) padding of XLA's SAME along one spatial dim."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def _check_conv_params(conv_layer_params):
  for layer in conv_layer_params:
    if (not isinstance(layer, (tuple, list)) or len(layer) != 3
        or not all(isinstance(v, int) for v in layer)):
      raise ValueError(
          "conv_layer_params takes (filters, kernel_size, stride) triples, "
          f"got {tuple(conv_layer_params)!r}; pass layer widths as "
          "fc_layer_params=")


class EncoderModule(nn.Module):
  """Per-leaf preprocessing and conv stack, concat, then the Dense stack.

  Args:
    input_spec: the observation spec nest.
    conv_layer_params: (filters, kernel_size, stride) per conv layer,
      applied to every leaf whose spec is ``[H, W, C]``.
    fc_layer_params: Dense layer widths.
    activation: applied after every conv and Dense layer.
    dropout_rate: dropout after every Dense layer, active only when
      ``training=True`` is passed to `forward`.
    dtype: compute dtype.
    preprocessing: applied to each leaf before the cast (e.g. uint8
      frames scaled by 1/255); with none, uint8 becomes raw 0-255 floats.
  """

  def __init__(self, input_spec, conv_layer_params=(),
               fc_layer_params: Sequence[int] = (64, 64),
               activation: Callable = F.relu,
               dropout_rate: Optional[float] = None,
               dtype: torch.dtype = torch.float32,
               preprocessing: Optional[Callable] = None, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__()
    _check_conv_params(conv_layer_params)
    device = resolve_device(device)
    self.activation = activation
    self.dropout_rate = dropout_rate
    self.dtype = dtype
    self.preprocessing = preprocessing
    self.convs = nn.ModuleList()
    # Per leaf: [(conv index, stride, F.pad widths or None, conv padding)]
    # for image leaves, [] for leaves that are only flattened.
    self._conv_plans: List[list] = []
    width = 0
    for spec in nest_utils.flatten(input_spec, is_leaf=array_spec._is_spec):
      if not conv_layer_params or len(spec.shape) < 2:
        self._conv_plans.append([])
        width += math.prod(spec.shape)
        continue
      if len(spec.shape) != 3:
        raise ValueError(
            f"the conv stack takes [H, W, C] observation leaves, got {spec}")
      h, w, channels = spec.shape
      plan = []
      for filters, kernel, stride in conv_layer_params:
        conv = nn.utils.skip_init(nn.Conv2d, channels, filters, kernel,
                                  stride=stride, device=device)
        variance_scaling_(conv.weight, 2.0, generator)
        nn.init.zeros_(conv.bias)
        (h_lo, h_hi), (w_lo, w_hi) = (same_padding(h, kernel, stride),
                                      same_padding(w, kernel, stride))
        if h_lo == h_hi and w_lo == w_hi:
          plan.append((len(self.convs), stride, None, (h_lo, w_lo)))
        else:
          plan.append((len(self.convs), stride, (w_lo, w_hi, h_lo, h_hi),
                       0))
        self.convs.append(conv)
        h, w, channels = -(-h // stride), -(-w // stride), filters
      self._conv_plans.append(plan)
      width += h * w * channels
    if conv_layer_params and not self.convs:
      raise ValueError(
          "conv_layer_params given, but no observation leaf is an image "
          "[H, W, C]")
    self.layers = nn.ModuleList()
    for out in fc_layer_params:
      layer = nn.utils.skip_init(nn.Linear, width, out, device=device)
      variance_scaling_(layer.weight, 2.0, generator)
      nn.init.zeros_(layer.bias)
      self.layers.append(layer)
      width = out
    self.output_size = width

  def _conv_stack(self, x, plan):
    x = x.permute(0, 3, 1, 2)                    # NHWC -> NCHW view
    for index, stride, pad, padding in plan:
      conv = self.convs[index]
      if pad is not None:
        x = F.pad(x, pad)
      x = F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                   stride=stride, padding=padding)
      x = self.activation(x)
    return x.permute(0, 2, 3, 1)                 # back to NHWC order

  def forward(self, observation, step_type=None, network_state=(),
              training: bool = False):
    processed = []
    for x, plan in zip(nest_utils.flatten(observation), self._conv_plans):
      if self.preprocessing is not None:
        x = self.preprocessing(x)
      x = x.to(self.dtype)
      if plan:
        x = self._conv_stack(x, plan)
      processed.append(x.reshape(x.shape[0], -1))
    x = processed[0] if len(processed) == 1 else torch.cat(processed, dim=-1)
    for layer in self.layers:
      x = self.activation(cast_linear(x, layer, self.dtype))
      if self.dropout_rate:
        x = F.dropout(x, self.dropout_rate, training=training)
    return x, network_state
