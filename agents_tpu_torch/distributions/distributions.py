"""Distributions for policy heads.

Port of the `Categorical` of ``agents_tpu/distributions/distributions.py``
(:200), the one distribution the DQN main path builds: `mode` and
`sample` only.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Categorical:
  """Categorical over the last dim of `logits`."""
  logits: torch.Tensor
  dtype: Any = torch.int32

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
