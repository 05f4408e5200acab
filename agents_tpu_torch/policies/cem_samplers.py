"""CEM action samplers: continuous, hybrid, and one-hot plus continuous.

Port of ``agents_tpu/policies/cem_samplers.py`` (:43-246). A sampler works
on a nested action spec. Its distribution parameters are a pair of tuples
(means, variances), one ``[B, *leaf]`` tensor per leaf, and its samples a
tuple of ``[N, B, *leaf]`` tensors, so the CEM policy scores all N
candidates of B rows in one batched critic call.

Leaves are taken in the JAX package's order, which sorts dict keys
(``jax.tree_util``); `unflatten` rebuilds the spec's own nest. The draws:
one normal ``[N, B, *leaf]`` per Gaussian leaf at "cem_normal", and for a
one-hot leaf of K classes one uniform ``[N, B, K]`` in [tiny, 1) at
"cem_categorical" (Gumbel noise, as `Categorical.sample`), leaf by leaf.

The spec bounds reach the device once per device and are kept, so a
sampler copies nothing to the card after its first call.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np
import torch

from agents_tpu_torch import distributions as dist_lib
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils

CEM_NORMAL_SITE = "cem_normal"
CEM_CATEGORICAL_SITE = "cem_categorical"


# The leaves of a spec (or value) nest with dict keys sorted, and back.
sorted_leaves = nest_utils.flatten_sorted
unflatten_sorted = nest_utils.unflatten_sorted


def _gather_elites(samples: torch.Tensor, elite_idx: torch.Tensor,
                   spec_shape) -> torch.Tensor:
  """samples [N, B, ...], elite_idx [B, E] -> [B, E, ...]."""
  samples_bt = samples.movedim(0, 1)
  idx = elite_idx.reshape(tuple(elite_idx.shape) + (1,) * len(spec_shape))
  idx = idx.expand(tuple(elite_idx.shape) + tuple(spec_shape))
  return torch.gather(samples_bt, 1, idx)


def _mean_var(elites: torch.Tensor):
  """``jnp.mean`` and ``jnp.var`` over the elites' axis 1."""
  mean = elites.mean(dim=1)
  var = torch.square(elites - mean.unsqueeze(1)).mean(dim=1)
  return mean, var


class ActionsSampler:
  """Base: distribution parameters and sampling, refit to elites and mode.

  `sample_clippers` are functions of the samples' tuple applied in turn
  after clipping to the spec.
  """

  def __init__(self, action_spec, sample_clippers: Sequence[Callable] = ()):
    self.action_spec = action_spec
    self.specs = sorted_leaves(action_spec)
    self.sample_clippers = tuple(sample_clippers)
    self._bounds_by_device: Dict[torch.device, list] = {}

  def unflatten(self, leaves):
    return unflatten_sorted(self.action_spec, leaves)

  def _bounds(self, device):
    """Per leaf, (minimum, maximum) as float32 tensors on `device`."""
    device = torch.device(device)
    if device not in self._bounds_by_device:
      self._bounds_by_device[device] = [
          tuple(torch.as_tensor(np.asarray(b, np.float32), device=device)
                for b in (s.minimum, s.maximum)) for s in self.specs]
    return self._bounds_by_device[device]

  def _gaussian_init(self, spec, bounds, batch_size, initial_std):
    lo, hi = bounds
    shape = (batch_size,) + spec.shape
    mean = ((lo + hi) / 2.0).expand(shape)
    std = ((hi - lo) * initial_std).expand(shape)
    return mean, std**2

  def _gaussian_sample(self, draws, num_samples, mean, var, bounds):
    eps = draws.normal(CEM_NORMAL_SITE, (num_samples,) + tuple(mean.shape),
                       dtype=mean.dtype)
    samples = mean[None] + torch.sqrt(var)[None] * eps
    return torch.clamp(samples, bounds[0], bounds[1])

  def init(self, batch_size: int, initial_std: float = 0.33, *, device):
    raise NotImplementedError

  def sample_batch_and_clip(self, draws, num_samples, dist_params):
    raise NotImplementedError

  def refit_distribution_to(self, elite_idx, samples):
    raise NotImplementedError

  def mode(self, dist_params):
    """The best single action per batch row from the fitted parameters."""
    raise NotImplementedError

  def _apply_clippers(self, actions):
    for clipper in self.sample_clippers:
      actions = clipper(actions)
    return actions


class GaussianContinuousSampler(ActionsSampler):
  """A Gaussian per bounded continuous leaf, its samples clipped to the
  bounds; the refit takes the elites' mean and variance plus 1e-6."""

  def __init__(self, action_spec, sample_clippers=()):
    super().__init__(action_spec, sample_clippers)
    for s in self.specs:
      if not array_spec.is_continuous(s):
        raise ValueError("continuous sampler requires continuous leaves")

  def init(self, batch_size, initial_std=0.33, *, device):
    params = [self._gaussian_init(s, b, batch_size, initial_std)
              for s, b in zip(self.specs, self._bounds(device))]
    return tuple(m for m, _ in params), tuple(v for _, v in params)

  def sample_batch_and_clip(self, draws, num_samples, dist_params):
    means, variances = dist_params
    bounds = self._bounds(means[0].device)
    return self._apply_clippers(tuple(
        self._gaussian_sample(draws, num_samples, m, v, b)
        for m, v, b in zip(means, variances, bounds)))

  def refit_distribution_to(self, elite_idx, samples):
    means, variances = [], []
    for s, leaf in zip(self.specs, samples):
      mean, var = _mean_var(_gather_elites(leaf, elite_idx, s.shape))
      means.append(mean)
      variances.append(var + 1e-6)
    return tuple(means), tuple(variances)

  def mode(self, dist_params):
    means, _ = dist_params
    bounds = self._bounds(means[0].device)
    return tuple(torch.clamp(m, lo, hi) for m, (lo, hi) in zip(means, bounds))


class GaussianHybridSampler(GaussianContinuousSampler):
  """Continuous and discrete leaves: a discrete leaf is sampled from the
  same clipped Gaussian, then rounded (half to even, as `jnp.round`); its
  mode is cast to the spec's dtype."""

  def __init__(self, action_spec, sample_clippers=()):
    ActionsSampler.__init__(self, action_spec, sample_clippers)

  def sample_batch_and_clip(self, draws, num_samples, dist_params):
    means, variances = dist_params
    bounds = self._bounds(means[0].device)
    out = []
    for s, m, v, b in zip(self.specs, means, variances, bounds):
      samples = self._gaussian_sample(draws, num_samples, m, v, b)
      out.append(torch.round(samples) if array_spec.is_discrete(s)
                 else samples)
    return self._apply_clippers(tuple(out))

  def mode(self, dist_params):
    out = []
    for s, m in zip(self.specs, super().mode(dist_params)):
      if array_spec.is_discrete(s):
        m = torch.round(m).to(array_spec.torch_dtype(s.dtype))
      out.append(m)
    return tuple(out)

  def to_spec_dtypes(self, samples):
    return tuple(leaf.to(array_spec.torch_dtype(s.dtype))
                 if array_spec.is_discrete(s) else leaf
                 for s, leaf in zip(self.specs, samples))


def is_one_hot(spec) -> bool:
  """A one-hot leaf: bounded, discrete, rank 1, maximum 1."""
  return (isinstance(spec, array_spec.BoundedArraySpec)
          and array_spec.is_discrete(spec) and len(spec.shape) == 1
          and int(np.max(spec.maximum)) == 1)


class GaussianOneHotSampler(ActionsSampler):
  """Gaussian continuous leaves, and one-hot leaves (`is_one_hot`) whose
  'mean' is a probability vector: a sample draws a category and one-hot
  encodes it, the refit averages the elites' one-hots (plus 1e-6,
  renormalized), the mode is the most probable category."""

  _is_one_hot = staticmethod(is_one_hot)

  def __init__(self, action_spec, sample_clippers=()):
    super().__init__(action_spec, sample_clippers)
    for s in self.specs:
      if array_spec.is_discrete(s) and not self._is_one_hot(s):
        raise ValueError(
            f"GaussianOneHotSampler handles one-hot discrete leaves "
            f"(rank-1, 0/1 bounds); got discrete spec {s}. Use "
            "GaussianHybridSampler for integer-index action leaves.")

  def init(self, batch_size, initial_std=0.33, *, device):
    means, variances = [], []
    for s, b in zip(self.specs, self._bounds(device)):
      if self._is_one_hot(s):
        k = s.shape[0]
        means.append(torch.full((batch_size, k), 1.0 / k, device=device))
        variances.append(torch.zeros((batch_size, k), device=device))
      else:
        mean, var = self._gaussian_init(s, b, batch_size, initial_std)
        means.append(mean)
        variances.append(var)
    return tuple(means), tuple(variances)

  def sample_batch_and_clip(self, draws, num_samples, dist_params):
    means, variances = dist_params
    bounds = self._bounds(means[0].device)
    out = []
    for s, m, v, b in zip(self.specs, means, variances, bounds):
      if self._is_one_hot(s):
        logits = torch.log(torch.clamp(m, min=1e-9))             # [B, K]
        idx = dist_lib.Categorical(logits.expand(
            (num_samples,) + tuple(logits.shape))).sample(
                draws, site=CEM_CATEGORICAL_SITE)
        out.append(torch.nn.functional.one_hot(idx.long(), s.shape[0]).to(
            torch.float32))                                       # [N, B, K]
      else:
        out.append(self._gaussian_sample(draws, num_samples, m, v, b))
    return self._apply_clippers(tuple(out))

  def refit_distribution_to(self, elite_idx, samples):
    means, variances = [], []
    for s, leaf in zip(self.specs, samples):
      elites = _gather_elites(leaf, elite_idx, s.shape)
      if self._is_one_hot(s):
        probs = elites.mean(dim=1) + 1e-6
        means.append(probs / probs.sum(dim=-1, keepdim=True))
        variances.append(torch.zeros_like(probs))
      else:
        mean, var = _mean_var(elites)
        means.append(mean)
        variances.append(var + 1e-6)
    return tuple(means), tuple(variances)

  def mode(self, dist_params):
    means, _ = dist_params
    bounds = self._bounds(means[0].device)
    out = []
    for s, m, (lo, hi) in zip(self.specs, means, bounds):
      if self._is_one_hot(s):
        out.append(torch.nn.functional.one_hot(
            torch.argmax(m, dim=-1), s.shape[0]).to(
                array_spec.torch_dtype(s.dtype)))
      else:
        out.append(torch.clamp(m, lo, hi))
    return tuple(out)


class ConcatenatedSampler:
  """`sampler` over its own action nest, whose actions are one flat float
  vector: its leaves, in its (sorted) order, cast to float32 and
  concatenated on the last axis (QT-Opt's 8-float action, sampled as a
  continuous leaf and a one-hot leaf by `GaussianOneHotSampler`). The
  policy's action spec is then one float leaf of the leaves' summed
  widths; exploration draws over `action_spec`, the inner nest
  (`policies/wrappers.py`)."""

  def __init__(self, sampler: ActionsSampler):
    self.sampler = sampler
    self.action_spec = sampler.action_spec
    self.specs = sampler.specs

  def init(self, batch_size: int, initial_std: float = 0.33, *, device):
    return self.sampler.init(batch_size, initial_std, device=device)

  def sample_batch_and_clip(self, draws, num_samples, dist_params):
    return self.sampler.sample_batch_and_clip(draws, num_samples,
                                              dist_params)

  def refit_distribution_to(self, elite_idx, samples):
    return self.sampler.refit_distribution_to(elite_idx, samples)

  def mode(self, dist_params):
    return self.sampler.mode(dist_params)

  def unflatten(self, leaves):
    return torch.cat([leaf.to(torch.float32) for leaf in leaves], dim=-1)
