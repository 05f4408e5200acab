"""Projection heads: encoder features -> a distribution over one action leaf.

Port of ``agents_tpu/networks/projection_networks.py``:
  - `CategoricalProjection` (:23-51): a Dense of ``n * num_actions``
    (U(±logits_init_scale) kernel, zero bias) to float32 logits shaped
    ``[..., *event_shape, num_actions]``, a `Categorical`, wrapped in
    `Independent` over the event dims when the spec has them ((1,));
  - `NormalProjection` (:54-101): means from a Dense with a
    U(±init_means_output_factor) kernel and zero bias; the std from a
    state-independent `std_bias` parameter (default) or a second Dense
    (`state_dependent_std`), through ``softplus(.) + min_std``; the mean
    tanh-squashed into the spec's bounds, giving `Independent(Normal)`, or
    with `scale_distribution` a `SquashedNormal` of the raw means;
  - `TanhNormalProjection` (:104-127), SAC's head: one Dense of ``2 *
    size`` (flax's default init: `lecun_normal_`, zero bias) split into
    means and log-stds clamped to [log_std_min, log_std_max], emitting a
    `SquashedNormal` into the spec's bounds;
  - `default_projection` (:130-140), the head for one action-spec leaf.

Every head is built as ``head(input_size, sample_spec, dtype=, device=,
generator=)`` (`functools.partial` sets its other arguments). The Dense
layers run in the compute dtype over float32 parameters; means, stds and
logits are float32.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from agents_tpu_torch import distributions as dist_lib
from agents_tpu_torch.distributions.distributions import _softplus
from agents_tpu_torch.networks.network import (cast_linear, lecun_normal_,
                                               uniform_symmetric_)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils.device import resolve_device


def _linear(input_size, output_size, device, init_scale, generator,
            bias_value: float = 0.0) -> nn.Linear:
  """A Linear with a U(±init_scale) weight and a constant bias."""
  layer = nn.utils.skip_init(nn.Linear, input_size, output_size,
                             device=device)
  uniform_symmetric_(layer.weight, init_scale, generator)
  nn.init.constant_(layer.bias, bias_value)
  return layer


def _register_bounds(module: nn.Module, sample_spec, device) -> None:
  """The spec's bounds as float32 buffers on the device, so `forward`
  copies nothing from the host."""
  for name, bound in (("low", sample_spec.minimum),
                      ("high", sample_spec.maximum)):
    module.register_buffer(
        name, torch.as_tensor(np.asarray(bound, np.float32), device=device),
        persistent=False)


class CategoricalProjection(nn.Module):
  """Logits head -> `Categorical` (`Independent` over a (1,) spec's dims).

  Args:
    input_size: width of the features.
    sample_spec: a discrete BoundedArraySpec of shape () or (1,).
  """

  def __init__(self, input_size: int, sample_spec,
               logits_init_scale: float = 0.1,
               dtype: torch.dtype = torch.float32, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__()
    device = resolve_device(device)
    self.num_actions = sample_spec.num_values
    self.event_shape = tuple(sample_spec.shape)
    self.dtype = dtype
    n = math.prod(self.event_shape)
    self.dense = _linear(input_size, n * self.num_actions, device,
                         logits_init_scale, generator)

  def forward(self, features):
    logits = cast_linear(features, self.dense, self.dtype)
    logits = logits.reshape(tuple(logits.shape[:-1]) + self.event_shape
                            + (self.num_actions,))
    dist = dist_lib.Categorical(logits.float())
    if self.event_shape:
      dist = dist_lib.Independent(
          dist, reinterpreted_batch_ndims=len(self.event_shape))
    return dist


class NormalProjection(nn.Module):
  """Mean and std head -> `Independent(Normal)` with the mean squashed
  into the spec's bounds, or a `SquashedNormal` (`scale_distribution`).

  Args:
    input_size: width of the features.
    sample_spec: the continuous BoundedArraySpec of the action leaf.
    std_bias_initializer_value: the initial std pre-activation
      (``log(exp(0.35) - 1)`` starts the std at 0.35 + min_std).
  """

  def __init__(self, input_size: int, sample_spec,
               state_dependent_std: bool = False,
               init_means_output_factor: float = 0.1,
               std_bias_initializer_value: float = 0.0,
               scale_distribution: bool = False, min_std: float = 1e-3,
               dtype: torch.dtype = torch.float32, device="cuda",
               generator: Optional[torch.Generator] = None):
    super().__init__()
    device = resolve_device(device)
    self.sample_spec = sample_spec
    self.size = math.prod(sample_spec.shape)
    self.state_dependent_std = state_dependent_std
    self.scale_distribution = scale_distribution
    self.min_std = min_std
    self.dtype = dtype
    self.means = _linear(input_size, self.size, device,
                         init_means_output_factor, generator)
    if state_dependent_std:
      self.stds = _linear(input_size, self.size, device,
                          init_means_output_factor, generator,
                          bias_value=std_bias_initializer_value)
    else:
      self.std_bias = nn.Parameter(torch.full(
          (self.size,), float(std_bias_initializer_value),
          dtype=torch.float32, device=device))
    _register_bounds(self, sample_spec, device)

  def forward(self, features):
    means = cast_linear(features, self.means, self.dtype)
    if self.state_dependent_std:
      stds_in = cast_linear(features, self.stds, self.dtype)
    else:
      stds_in = self.std_bias.to(self.dtype).expand(means.shape)
    shape = tuple(means.shape[:-1]) + tuple(self.sample_spec.shape)
    means = means.reshape(shape).float()
    std = _softplus(stds_in.reshape(shape).float()) + self.min_std
    event_ndims = len(self.sample_spec.shape)
    if self.scale_distribution:
      return dist_lib.SquashedNormal(loc=means, scale=std, low=self.low,
                                     high=self.high, event_ndims=event_ndims)
    mean = self.low + (self.high - self.low) / 2.0 * (torch.tanh(means) + 1.0)
    return dist_lib.Independent(dist_lib.Normal(mean, std),
                                reinterpreted_batch_ndims=event_ndims)


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
    _register_bounds(self, sample_spec, device)

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


def default_projection(input_size: int, sample_spec,
                       continuous_projection=NormalProjection,
                       dtype: torch.dtype = torch.float32, device="cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> nn.Module:
  """The head for one action-spec leaf: `CategoricalProjection` for a
  discrete leaf of shape () or (1,), else `continuous_projection`."""
  if not array_spec.is_continuous(sample_spec):
    if sample_spec.shape not in ((), (1,)):
      raise ValueError(
          f"Discrete projection requires scalar action spec, got {sample_spec}")
    return CategoricalProjection(input_size, sample_spec, dtype=dtype,
                                 device=device, generator=generator)
  return continuous_projection(input_size, sample_spec, dtype=dtype,
                               device=device, generator=generator)
