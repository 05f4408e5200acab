"""Streaming and EMA observation/reward normalizers (PPO).

Port of ``agents_tpu/utils/tensor_normalizer.py``: `StreamingTensorNormalizer`
(:28-97) and `EMATensorNormalizer` (:106-159), with the JAX package's split
into a state (a frozen dataclass of spec-shaped nests of float32 tensors)
and pure `update` / `normalize` functions. Each value leaf is ``[outer...,
*spec shape]``; `update` reduces over the outer dims.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils


def _outer_dims(x: torch.Tensor, inner_rank: int):
  return tuple(range(x.dim() - inner_rank))


def _mean(x, dims):
  # torch reduces every dim when given none; the JAX package's mean over
  # no axes is the identity.
  return x.mean(dim=dims) if dims else x


def _sum(x, dims):
  return x.sum(dim=dims) if dims else x


def _normalize(x, mean, var, epsilon, clip_value, center_mean):
  std = torch.sqrt(torch.clamp(var, min=0.0)) + epsilon
  x = x.float()
  out = (x - mean if center_mean else x) / std
  if clip_value > 0:
    out = torch.clamp(out, -clip_value, clip_value)
  return out


@dataclasses.dataclass(frozen=True)
class StreamingNormalizerState:
  count: Any      # per-leaf [inner...] float32
  mean_sum: Any   # per-leaf sum of values
  var_sum: Any    # per-leaf sum of squared deviations from the running mean


class StreamingTensorNormalizer:
  """Counts and sums over every value seen; normalizes with mean =
  mean_sum / count and var = var_sum / count. The count starts at 1e-8."""

  def __init__(self, spec, epsilon: float = 1e-8):
    self.spec = spec
    self.epsilon = epsilon

  def init(self, device) -> StreamingNormalizerState:
    full = lambda v: array_spec.map_spec_nest(  # noqa: E731
        lambda s: torch.full(s.shape, v, dtype=torch.float32, device=device),
        self.spec)
    return StreamingNormalizerState(count=full(1e-8), mean_sum=full(0.0),
                                    var_sum=full(0.0))

  def update(self, state: StreamingNormalizerState,
             values) -> StreamingNormalizerState:
    """Chan's exact parallel-variance combine of `values` into `state`."""

    def _upd(count, mean_sum, var_sum, x):
      dims = _outer_dims(x, mean_sum.dim())
      n = math.prod(x.shape[d] for d in dims)
      x = x.float()
      batch_mean = _mean(x, dims)
      batch_m2 = _sum(torch.square(x - batch_mean), dims)
      old_mean = mean_sum / torch.clamp(count, min=1e-8)
      new_count = count + n
      delta = batch_mean - old_mean
      new_var_sum = (var_sum + batch_m2
                     + torch.square(delta) * count * n / new_count)
      return new_count, mean_sum + _sum(x, dims), new_var_sum

    outs = [_upd(*leaves) for leaves in zip(
        nest_utils.flatten(state.count), nest_utils.flatten(state.mean_sum),
        nest_utils.flatten(state.var_sum), nest_utils.flatten(values))]
    return StreamingNormalizerState(
        *(_unflatten(values, [o[i] for o in outs]) for i in range(3)))

  def normalize(self, state: StreamingNormalizerState, values,
                clip_value: float = 5.0, center_mean: bool = True):
    def _norm(count, mean_sum, var_sum, x):
      denom = torch.clamp(count, min=1e-8)
      return _normalize(x, mean_sum / denom, var_sum / denom, self.epsilon,
                        clip_value, center_mean)

    return nest_utils.tree_map(_norm, state.count, state.mean_sum,
                               state.var_sum, values)


def _unflatten(structure, leaves):
  it = iter(leaves)
  return nest_utils.tree_map(lambda _: next(it), structure)


@dataclasses.dataclass(frozen=True)
class EMANormalizerState:
  mean: Any
  var: Any


class EMATensorNormalizer:
  """Exponential moving averages of the mean and of the variance, the
  variance taken about the moving mean (so a batch of one still moves
  it)."""

  def __init__(self, spec, norm_update_rate: float = 0.001,
               epsilon: float = 1e-8):
    self.spec = spec
    self.rate = norm_update_rate
    self.epsilon = epsilon

  def init(self, device) -> EMANormalizerState:
    full = lambda v: array_spec.map_spec_nest(  # noqa: E731
        lambda s: torch.full(s.shape, v, dtype=torch.float32, device=device),
        self.spec)
    return EMANormalizerState(mean=full(0.0), var=full(1.0))

  def update(self, state: EMANormalizerState, values) -> EMANormalizerState:
    def _upd(mean, var, x):
      dims = _outer_dims(x, mean.dim())
      x = x.float()
      batch_mean = _mean(x, dims)
      batch_var = _mean(torch.square(x - mean), dims)
      return (mean + self.rate * (batch_mean - mean),
              var + self.rate * (batch_var - var))

    outs = [_upd(m, v, x) for m, v, x in zip(
        nest_utils.flatten(state.mean), nest_utils.flatten(state.var),
        nest_utils.flatten(values))]
    return EMANormalizerState(
        mean=_unflatten(values, [o[0] for o in outs]),
        var=_unflatten(values, [o[1] for o in outs]))

  def normalize(self, state: EMANormalizerState, values,
                clip_value: float = 5.0, center_mean: bool = True):
    return nest_utils.tree_map(
        lambda mean, var, x: _normalize(x, mean, var, self.epsilon,
                                        clip_value, center_mean),
        state.mean, state.var, values)
