"""Network base and the JAX package's initializers.

Port of ``agents_tpu/networks/network.py``. A network is an `nn.Module`
that keeps the specs it was built from and follows the JAX package's
calling convention:

    output, new_state = net(observation, step_type, network_state)

Stateless networks take and return ``network_state=()``. Parameters live in
the module; they are initialised at construction from an explicit
`torch.Generator`. The initializers are flax's: `variance_scaling_`,
`lecun_normal_` (flax's Dense default) and `uniform_symmetric_`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# Standard deviation of a unit normal cut at +-2 sigma (flax's constant).
_TRUNCATED_NORMAL_STDDEV = 0.87962566103423978


def variance_scaling_(weight: torch.Tensor, scale: float = 2.0,
                      generator: Optional[torch.Generator] = None):
  """Flax's ``variance_scaling(scale, "fan_in", "truncated_normal")`` on a
  Linear weight ``[out, in]`` or a conv weight ``[out, in, kh, kw]``:
  std = sqrt(scale / fan_in) / 0.8796..., cut at +-2 std, where fan_in is
  ``in * kh * kw`` (flax's fan-in of the HWIO kernel)."""
  fan_in = math.prod(weight.shape[1:])
  std = math.sqrt(scale / fan_in) / _TRUNCATED_NORMAL_STDDEV
  with torch.no_grad():
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
  """Flax's default Dense kernel init, ``lecun_normal``: that is
  ``variance_scaling(1.0, "fan_in", "truncated_normal")``."""
  return variance_scaling_(weight, 1.0, generator)


def uniform_symmetric_(weight: torch.Tensor, scale: float,
                       generator: Optional[torch.Generator] = None):
  """U(-scale, scale)."""
  with torch.no_grad():
    return nn.init.uniform_(weight, -scale, scale, generator=generator)


def cast_linear(x: torch.Tensor, layer: nn.Linear,
                dtype: torch.dtype) -> torch.Tensor:
  """`layer` applied in `dtype`: its float32 weight and bias are cast at
  use, as flax's ``Dense(dtype=...)`` does with float32 params."""
  return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


def seeded_generator(device, generator: Optional[torch.Generator] = None,
                     seed: int = 0) -> torch.Generator:
  """`generator`, or a fresh generator on `device` seeded with `seed`."""
  if generator is None:
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
  return generator


class Network(nn.Module):
  """An nn.Module with the specs it was built from.

  Attributes:
    input_spec: observation spec nest the module consumes.
    state_spec: nest of ArraySpec for recurrent state (() if stateless).
  """

  def __init__(self, input_spec, state_spec=()):
    super().__init__()
    self.input_spec = input_spec
    self.state_spec = state_spec
