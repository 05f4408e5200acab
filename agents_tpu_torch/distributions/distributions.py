"""Distributions for policy heads.

Port of ``agents_tpu/distributions/distributions.py``: `Normal`,
`Independent` and `SquashedNormal` (:54-196), `Categorical` (:199-235),
`Deterministic` (:414-439) and `kl_divergence` (:441).

`log_prob` returns one value per batch element: `Independent` and
`SquashedNormal` sum their event dims. Sampling takes a draw source and
the name of its site in place of a PRNG key (`agents_tpu_torch.utils.
draws`); `sample_shape` is prepended to the batch shape. Distributions are
nests (`agents_tpu_torch.utils.nest_utils`): their parameter tensors are
the leaves, and `dtype`, `reinterpreted_batch_ndims` and `event_ndims` are
static fields, as flax's ``pytree_node=False`` makes them in the JAX
package, so a rollout's distributions stack, slice and shuffle like any
other part of a trajectory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from agents_tpu_torch.utils.nest_utils import static_field

_LOG_2 = math.log(2.0)
_LOG_2PI = math.log(2.0 * math.pi)
_HALF_LOG_2PIE = 0.5 * math.log(2.0 * math.pi * math.e)


def _sum_event_dims(x: torch.Tensor, event_ndims: int) -> torch.Tensor:
  if not event_ndims:
    return x
  return torch.sum(x, dim=tuple(range(-event_ndims, 0)))


def _batch_shape(loc, scale):
  return torch.broadcast_shapes(torch.as_tensor(loc).shape,
                                torch.as_tensor(scale).shape)


def _softplus(x: torch.Tensor) -> torch.Tensor:
  """``jax.nn.softplus``: ``logaddexp(x, 0)``, with no threshold branch."""
  return torch.logaddexp(x, torch.zeros_like(x))


class _Distribution:

  def sample_and_log_prob(self, draws, sample_shape=(), site: str = "normal"):
    x = self.sample(draws, sample_shape, site)
    return x, self.log_prob(x)


@dataclasses.dataclass(frozen=True)
class Normal(_Distribution):
  """Normal(loc, scale); its batch shape broadcasts loc with scale."""
  loc: Any
  scale: Any

  def sample(self, draws, sample_shape=(), site: str = "normal"):
    shape = tuple(sample_shape) + tuple(_batch_shape(self.loc, self.scale))
    return self.loc + self.scale * draws.normal(site, shape)

  def log_prob(self, value):
    z = (value - self.loc) / self.scale
    return -0.5 * (z**2 + _LOG_2PI) - torch.log(self.scale)

  def entropy(self):
    return (_HALF_LOG_2PIE + torch.log(self.scale)).expand(
        _batch_shape(self.loc, self.scale))

  def mode(self):
    return self.loc.expand(_batch_shape(self.loc, self.scale))

  def mean(self):
    return self.mode()

  def stddev(self):
    return self.scale.expand(_batch_shape(self.loc, self.scale))

  def kl_divergence(self, other: "Normal"):
    var_ratio = (self.scale / other.scale) ** 2
    t1 = ((self.loc - other.loc) / other.scale) ** 2
    return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))


@dataclasses.dataclass(frozen=True)
class Independent(_Distribution):
  """Reinterprets the last `reinterpreted_batch_ndims` dims as event dims."""
  base: Any
  reinterpreted_batch_ndims: int = static_field(default=1)

  def sample(self, draws, sample_shape=(), site: str = "normal"):
    return self.base.sample(draws, sample_shape, site)

  def log_prob(self, value):
    return _sum_event_dims(self.base.log_prob(value),
                           self.reinterpreted_batch_ndims)

  def entropy(self):
    return _sum_event_dims(self.base.entropy(),
                           self.reinterpreted_batch_ndims)

  def mode(self):
    return self.base.mode()

  def mean(self):
    return self.base.mean()

  def stddev(self):
    return self.base.stddev()

  def kl_divergence(self, other):
    base_other = other.base if isinstance(other, Independent) else other
    return _sum_event_dims(self.base.kl_divergence(base_other),
                           self.reinterpreted_batch_ndims)


@dataclasses.dataclass(frozen=True)
class SquashedNormal(_Distribution):
  """Normal squashed by tanh, then mapped affinely into [low, high]:

      action = low + (high - low) / 2 * (tanh(u) + 1),  u ~ Normal(loc, scale)

  `log_prob` uses the stable log-det ``log(1 - tanh(u)^2) = 2 (log 2 - u -
  softplus(-2u))`` plus ``log(half_range)`` and sums the event dims, as the
  JAX package does. There is no analytic entropy.
  """
  loc: Any
  scale: Any
  low: Any = 0.0
  high: Any = 1.0
  event_ndims: int = static_field(default=1)

  @property
  def _half_range(self):
    return (self.high - self.low) / 2.0

  def _squash(self, u):
    return self.low + self._half_range * (torch.tanh(u) + 1.0)

  def _unsquash(self, x):
    y = (x - self.low) / self._half_range - 1.0
    return torch.atanh(torch.clamp(y, -1.0 + 1e-6, 1.0 - 1e-6))

  def _sample_u(self, draws, sample_shape, site):
    shape = tuple(sample_shape) + tuple(_batch_shape(self.loc, self.scale))
    return self.loc + self.scale * draws.normal(site, shape,
                                                dtype=self.loc.dtype)

  def sample(self, draws, sample_shape=(), site: str = "normal"):
    return self._squash(self._sample_u(draws, sample_shape, site))

  def sample_and_log_prob(self, draws, sample_shape=(), site: str = "normal"):
    u = self._sample_u(draws, sample_shape, site)
    return self._squash(u), self._log_prob_from_u(u)

  def _log_prob_from_u(self, u):
    base = Normal(self.loc, self.scale).log_prob(u)
    log_det = (torch.log(self._half_range + torch.zeros_like(u))
               + 2.0 * (_LOG_2 - u - _softplus(-2.0 * u)))
    return _sum_event_dims(base - log_det, self.event_ndims)

  def log_prob(self, value):
    return self._log_prob_from_u(self._unsquash(value))

  def mode(self):
    return self._squash(self.loc)

  def mean(self):
    return self._squash(self.loc)

  def stddev(self):
    return self._half_range * self.scale


@dataclasses.dataclass(frozen=True)
class Categorical(_Distribution):
  """Categorical over the last dim of `logits`."""
  logits: torch.Tensor
  dtype: Any = static_field(default=torch.int32)

  @property
  def probs(self):
    return torch.softmax(self.logits, dim=-1)

  @property
  def log_probs(self):
    return torch.log_softmax(self.logits, dim=-1)

  def log_prob(self, value):
    """The log-probability of `value` (int32 actions index as int64)."""
    return torch.gather(self.log_probs, -1,
                        value.long().unsqueeze(-1)).squeeze(-1)

  def entropy(self):
    lp = self.log_probs
    return -torch.sum(torch.exp(lp) * lp, dim=-1)

  def kl_divergence(self, other: "Categorical"):
    lp = self.log_probs
    return torch.sum(torch.exp(lp) * (lp - other.log_probs), dim=-1)

  def mode(self):
    """argmax; the first index wins ties (as `jnp.argmax`)."""
    return torch.argmax(self.logits, dim=-1).to(self.dtype)

  def sample(self, draws, sample_shape=(), site: str = "categorical"):
    """Gumbel-max sample with uniform draws from `draws` under `site`."""
    shape = tuple(sample_shape) + tuple(self.logits.shape)
    tiny = torch.finfo(self.logits.dtype).tiny
    u = draws.uniform(site, shape, tiny, 1.0, dtype=self.logits.dtype)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(self.logits + gumbel, dim=-1).to(self.dtype)


@dataclasses.dataclass(frozen=True)
class Deterministic(_Distribution):
  """All mass at `loc`; the last `event_ndims` dims are event dims."""
  loc: Any
  event_ndims: int = static_field(default=0)

  def sample(self, draws=None, sample_shape=(), site: str = "normal"):
    return self.loc.expand(tuple(sample_shape) + tuple(self.loc.shape))

  def log_prob(self, value):
    lp = torch.where(value == self.loc, 0.0, -math.inf)
    return _sum_event_dims(lp, self.event_ndims)

  def entropy(self):
    return torch.zeros(self.loc.shape[:self.loc.dim() - self.event_ndims],
                       device=self.loc.device)

  def mode(self):
    return self.loc

  def mean(self):
    return self.loc


def kl_divergence(d1, d2):
  return d1.kl_divergence(d2)
