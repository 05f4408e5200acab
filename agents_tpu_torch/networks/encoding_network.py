"""Spec-driven encoder: preprocessing -> conv -> MLP.

Port of ``agents_tpu/networks/encoding_network.py`` (`EncoderModule` and
the registered factory `make_encoding_network`, :66-73).
For each observation leaf, in order: the optional `preprocessing`, a cast
to the compute dtype, the conv stack if the leaf is an image
``[B, H, W, C]``, and a flatten past the batch dim. The leaves are then
concatenated and pass through the ReLU Dense stack.

Layouts follow flax, so converted weights apply unchanged:
  - the observation stays NHWC; ``permute(0, 3, 1, 2)`` views it as NCHW
    in channels-last memory, which cuDNN takes without a copy;
  - each conv pads as XLA's SAME does (`same_padding`): torch's
    ``padding="same"`` refuses stride > 1; with ``padding="VALID"`` it
    does not pad (``(size - kernel) // stride + 1`` outputs, the
    published Atari torsos' 84 -> 20 -> 9 -> 7); `padding` may also give
    one of the two per conv layer;
  - `max_pools` puts an unpadded max-pool after a conv layer's
    activation (QT-Opt's torso: 472 -> 234 -> 78 -> 26);
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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from agents_tpu_torch.networks.network import (Network, cast_linear,
                                               seeded_generator,
                                               variance_scaling_)
from agents_tpu_torch.networks.registry import register_factory
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
  """(low, high) padding of XLA's SAME along one spatial dim."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


PADDINGS = ("SAME", "VALID")


def conv_output_size(size: int, kernel: int, stride: int,
                     padding: str = "SAME") -> int:
  """Outputs of one conv along a spatial dim of `size`."""
  if padding == "SAME":
    return -(-size // stride)
  return (size - kernel) // stride + 1


def _paddings(padding, layers: int) -> Tuple[str, ...]:
  """One padding per conv layer from `padding` (one for all, or one
  each)."""
  paddings = (padding,) * layers if isinstance(padding, str) \
      else tuple(padding)
  if len(paddings) != layers or any(p not in PADDINGS for p in paddings):
    raise ValueError(f"padding is one of {PADDINGS} or one of them per "
                     f"conv layer, got {padding!r}")
  return paddings


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
    kernel_init: fills each conv and Dense weight in place, called as
      ``kernel_init(weight, generator=generator)``; flax's
      ``variance_scaling(2.0, "fan_in", "truncated_normal")`` by default.
    padding: "SAME" (XLA's, the default) or "VALID" (none), or one of
      them per conv layer.
    max_pools: {conv layer index: (kernel_size, stride)}: an unpadded
      max-pool after that layer's activation.
  """

  def __init__(self, input_spec, conv_layer_params=(),
               fc_layer_params: Sequence[int] = (64, 64),
               activation: Callable = F.relu,
               dropout_rate: Optional[float] = None,
               dtype: torch.dtype = torch.float32,
               preprocessing: Optional[Callable] = None, device="cuda",
               generator: Optional[torch.Generator] = None,
               kernel_init: Callable = variance_scaling_,
               padding="SAME",
               max_pools: Optional[Dict[int, Tuple[int, int]]] = None):
    super().__init__()
    _check_conv_params(conv_layer_params)
    paddings = _paddings(padding, len(conv_layer_params))
    max_pools = dict(max_pools or {})
    if not set(max_pools) <= set(range(len(conv_layer_params))):
      raise ValueError(f"max_pools names conv layers {sorted(max_pools)} of "
                       f"{len(conv_layer_params)}")
    device = resolve_device(device)
    self.activation = activation
    self.dropout_rate = dropout_rate
    self.dtype = dtype
    self.preprocessing = preprocessing
    self.convs = nn.ModuleList()
    # Per leaf: [(conv index, stride, F.pad widths or None, conv padding)]
    # for image leaves, [] for leaves that are only flattened.
    self._conv_plans: List[list] = []
    # {index into `convs`: (kernel, stride)} of the max-pools.
    self._pools: Dict[int, Tuple[int, int]] = {}
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
      for layer, (filters, kernel, stride) in enumerate(conv_layer_params):
        padding = paddings[layer]
        conv = nn.utils.skip_init(nn.Conv2d, channels, filters, kernel,
                                  stride=stride, device=device)
        kernel_init(conv.weight, generator=generator)
        nn.init.zeros_(conv.bias)
        (h_lo, h_hi), (w_lo, w_hi) = (same_padding(h, kernel, stride),
                                      same_padding(w, kernel, stride)) \
            if padding == "SAME" else ((0, 0), (0, 0))
        if h_lo == h_hi and w_lo == w_hi:
          plan.append((len(self.convs), stride, None, (h_lo, w_lo)))
        else:
          plan.append((len(self.convs), stride, (w_lo, w_hi, h_lo, h_hi),
                       0))
        self.convs.append(conv)
        h, w = (conv_output_size(h, kernel, stride, padding),
                conv_output_size(w, kernel, stride, padding))
        channels = filters
        if layer in max_pools:
          pool_kernel, pool_stride = max_pools[layer]
          self._pools[len(self.convs) - 1] = (pool_kernel, pool_stride)
          h, w = (conv_output_size(h, pool_kernel, pool_stride, "VALID"),
                  conv_output_size(w, pool_kernel, pool_stride, "VALID"))
      self._conv_plans.append(plan)
      width += h * w * channels
    if conv_layer_params and not self.convs:
      raise ValueError(
          "conv_layer_params given, but no observation leaf is an image "
          "[H, W, C]")
    self.layers = nn.ModuleList()
    for out in fc_layer_params:
      layer = nn.utils.skip_init(nn.Linear, width, out, device=device)
      kernel_init(layer.weight, generator=generator)
      nn.init.zeros_(layer.bias)
      self.layers.append(layer)
      width = out
    self.output_size = width

  def conv_map(self, x, plan=None):
    """The conv stack (leaf `plan`'s; the first image leaf's by default)
    over NHWC images `x`, already preprocessed and cast: its NCHW
    output map."""
    if plan is None:
      plan = next(p for p in self._conv_plans if p)
    x = x.permute(0, 3, 1, 2)                    # NHWC -> NCHW view
    for index, stride, pad, padding in plan:
      conv = self.convs[index]
      if pad is not None:
        x = F.pad(x, pad)
      x = F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                   stride=stride, padding=padding)
      x = self.activation(x)
      pool = self._pools.get(index)
      if pool is not None:
        x = F.max_pool2d(x, pool[0], pool[1])
    return x

  def _conv_stack(self, x, plan):
    return self.conv_map(x, plan).permute(0, 2, 3, 1)  # back to NHWC order

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


class EncodingNetwork(Network):
  """An `EncoderModule` as a network: ``(features, network_state)``."""

  def __init__(self, input_spec, encoder: EncoderModule):
    super().__init__(input_spec)
    self.encoder = encoder

  def forward(self, observation, step_type=None, network_state=(),
              training: bool = False):
    return self.encoder(observation, step_type, network_state, training)


@register_factory
def make_encoding_network(input_spec, conv_layer_params=(),
                          fc_layer_params=(64, 64),
                          activation: Callable = F.relu,
                          dtype: torch.dtype = torch.float32, device="cuda",
                          generator: Optional[torch.Generator] = None
                          ) -> EncodingNetwork:
  """An `EncodingNetwork` on `device`, initialised from `generator` (a
  fresh generator seeded 0 on the device when None)."""
  device = resolve_device(device)
  return EncodingNetwork(input_spec, EncoderModule(
      input_spec, tuple(conv_layer_params), tuple(fc_layer_params),
      activation, dtype=dtype, device=device,
      generator=seeded_generator(device, generator)))
