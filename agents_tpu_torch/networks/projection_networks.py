"""Projection heads: encoder features -> a distribution over one action leaf.

Port of `TanhNormalProjection` of
``agents_tpu/networks/projection_networks.py`` (:104-127), SAC's head: one
Dense of ``2 * size`` (flax's default init: `lecun_normal_`, zero bias) is
split into means and log-stds; the log-stds are clamped to
[log_std_min, log_std_max] and the head emits a `SquashedNormal` into the
spec's bounds. The Dense runs in the compute dtype; means and log-stds
are float32. `NormalProjection` and `CategoricalProjection` are not
ported yet.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from agents_tpu_torch import distributions as dist_lib
from agents_tpu_torch.networks.network import cast_linear, lecun_normal_
from agents_tpu_torch.utils.device import resolve_device


class TanhNormalProjection(nn.Module):
  """State-dependent log-std, tanh-squashed into ``sample_spec``'s bounds.

  Args:
    input_size: width of the features.
    sample_spec: the BoundedArraySpec of the action leaf.
  """

  def __init__(self, input_size: int, sample_spec,
               dtype: torch.dtype = torch.float32,
               log_std_min: float = -20.0, log_std_max: float = 2.0,
               device="cuda", generator=None):
    super().__init__()
    device = resolve_device(device)
    self.sample_spec = sample_spec
    self.size = math.prod(sample_spec.shape)
    self.dtype = dtype
    self.log_std_min = log_std_min
    self.log_std_max = log_std_max
    self.dense = nn.utils.skip_init(nn.Linear, input_size, 2 * self.size,
                                    device=device)
    lecun_normal_(self.dense.weight, generator)
    nn.init.zeros_(self.dense.bias)
    # On the device once, so `forward` copies nothing from the host.
    for name, bound in (("low", sample_spec.minimum),
                        ("high", sample_spec.maximum)):
      self.register_buffer(
          name, torch.as_tensor(np.asarray(bound, np.float32), device=device),
          persistent=False)

  def forward(self, features) -> dist_lib.SquashedNormal:
    out = cast_linear(features, self.dense, self.dtype)
    means, log_stds = out.split(self.size, dim=-1)
    shape = tuple(out.shape[:-1]) + tuple(self.sample_spec.shape)
    means = means.reshape(shape).float()
    log_stds = torch.clamp(log_stds.reshape(shape).float(), self.log_std_min,
                           self.log_std_max)
    return dist_lib.SquashedNormal(
        loc=means, scale=torch.exp(log_stds), low=self.low, high=self.high,
        event_ndims=len(self.sample_spec.shape))
