"""Shared training utilities.

Port of the main path's part of ``agents_tpu/utils/common.py``:
`LossInfo`, `soft_variables_update`, `periodic_soft_update`,
`index_with_actions`, the element-wise losses, `aggregate_losses`,
`clip_gradient_norms`, and `log_probability` and `entropy` over nests of
distributions (:101-122). Target updates and gradient clipping act on the
tensors in place.
"""
from __future__ import annotations

from typing import Any, Iterable, NamedTuple, Optional

import torch

from agents_tpu_torch.utils import nest_utils


class LossInfo(NamedTuple):
  """(loss, extra) as produced by every agent."""
  loss: Any
  extra: Any = ()


@torch.no_grad()
def soft_variables_update(source_params: Iterable[torch.Tensor],
                          target_params: Iterable[torch.Tensor],
                          tau: float = 1.0) -> None:
  """Polyak averaging in place: target <- tau*source + (1-tau)*target.

  With tau == 1.0 this is a copy.
  """
  for s, t in zip(source_params, target_params):
    if tau == 1.0:
      t.copy_(s)
    else:
      t.mul_(1.0 - tau).add_(s, alpha=tau)


def periodically(step: int, period: int) -> bool:
  """True every `period` steps."""
  return step % period == 0


def periodic_soft_update(step: int, period: int, source_params,
                         target_params, tau: float) -> bool:
  """Apply the polyak update when `step` is a multiple of `period`.

  `step` is a host int (the agent keeps a host mirror of its train step),
  so the branch costs no device work on the steps it skips. Returns
  whether the update ran.
  """
  if not periodically(step, period):
    return False
  soft_variables_update(source_params, target_params, tau)
  return True


def index_with_actions(q_values: torch.Tensor,
                       actions: torch.Tensor) -> torch.Tensor:
  """q_values[..., actions] along the last dim."""
  return torch.gather(q_values, -1, actions.long().unsqueeze(-1)).squeeze(-1)


def element_wise_squared_loss(x, y):
  """Squared error without the 0.5 factor."""
  return torch.square(x - y)


def element_wise_huber_loss(x, y, delta: float = 1.0):
  """Per-element Huber loss."""
  abs_err = torch.abs(x - y)
  quadratic = torch.clamp(abs_err, max=delta)
  linear = abs_err - quadratic
  return 0.5 * quadratic**2 + delta * linear


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
  return torch.sqrt(sum(torch.sum(torch.square(t)) for t in tensors))


@torch.no_grad()
def clip_gradient_norms(grads, max_norm: float) -> None:
  """Global-norm clipping in place: grads *= min(1, max_norm / norm)."""
  grads = [g for g in grads if g is not None]
  scale = torch.clamp(max_norm / torch.clamp(global_norm(grads), min=1e-12),
                      max=1.0)
  for g in grads:
    g.mul_(scale)


def _sum_leaves(nest):
  leaves = nest_utils.flatten(nest)
  total = leaves[0]
  for leaf in leaves[1:]:
    total = total + leaf
  return total


def log_probability(distributions, actions):
  """Sum of per-leaf log-probs over a nest of distributions."""
  return _sum_leaves(nest_utils.tree_map(
      lambda d, a: d.log_prob(a), distributions, actions,
      is_leaf=lambda x: hasattr(x, "log_prob")))


def entropy(distributions):
  """Sum of per-leaf entropies over a nest of distributions."""
  return _sum_leaves(nest_utils.tree_map(
      lambda d: d.entropy(), distributions,
      is_leaf=lambda x: hasattr(x, "entropy")))


def aggregate_losses(per_example_loss: Optional[torch.Tensor] = None,
                     sample_weight: Optional[torch.Tensor] = None,
                     regularization_loss: Optional[torch.Tensor] = None,
                     global_batch_size: Optional[int] = None):
  """Scalar loss: sum(per_example * weight) / (global_batch_size or
  per_example.numel()), plus the summed regularization loss."""
  total = 0.0
  if per_example_loss is not None:
    loss = per_example_loss
    if sample_weight is not None:
      loss = loss * sample_weight
    denom = global_batch_size if global_batch_size is not None \
        else loss.numel()
    total = total + torch.sum(loss) / denom
  if regularization_loss is not None:
    total = total + torch.sum(regularization_loss)
  return total
