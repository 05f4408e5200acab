"""Shared training utilities.

Port of ``agents_tpu/utils/common.py``: `LossInfo`,
`soft_variables_update`, `periodic_soft_update`, `index_with_actions`
(with `multi_dim_actions`), the element-wise losses, `aggregate_losses`,
`replicate`, `clip_gradient_norms`, `log_probability` and `entropy` over nests of
distributions (:101-122), `discounted_future_sum` (:125), `compute_returns`
(:141) and `OUProcess` (:150). Target updates and gradient clipping act on
the tensors in place.
"""
from __future__ import annotations

import math
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


def index_with_actions(q_values: torch.Tensor, actions: torch.Tensor,
                       multi_dim_actions: bool = False) -> torch.Tensor:
  """q_values[..., actions] along the last dim.

  With `multi_dim_actions`, the trailing dim of `actions` indexes as many
  trailing dims of `q_values`: q ``[B..., d1, ..., dk]`` with actions
  ``[B..., k]`` gives ``[B...]`` (a batch-dims gather); a q_values rank
  other than the outer rank plus k raises ValueError."""
  actions = actions.long()
  if multi_dim_actions:
    k = actions.shape[-1]
    if q_values.dim() != actions.dim() - 1 + k:
      raise ValueError(
          f"q_values rank {q_values.dim()} does not match outer rank "
          f"{actions.dim() - 1} + {k} action dims")
    outer = actions.shape[:-1]
    flat_q = q_values.reshape(math.prod(outer), -1)
    strides = torch.tensor(
        [math.prod(q_values.shape[len(outer) + i + 1:]) for i in range(k)],
        dtype=torch.long, device=actions.device)
    flat_a = (actions.reshape(-1, k) * strides).sum(-1)
    return flat_q.gather(1, flat_a.unsqueeze(1)).reshape(outer)
  return torch.gather(q_values, -1, actions.unsqueeze(-1)).squeeze(-1)


def element_wise_squared_loss(x, y):
  """Squared error without the 0.5 factor."""
  return torch.square(x - y)


def element_wise_sigmoid_cross_entropy(targets, logits):
  """Per-element cross-entropy of probability `targets` in [0, 1] under
  sigmoid(`logits`), taken stably from the logits."""
  return torch.nn.functional.binary_cross_entropy_with_logits(
      logits, targets, reduction="none")


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


def log_probability(distributions, actions, action_spec=None):
  """Sum of per-leaf log-probs over a nest of distributions. Each leaf's
  log-prob is already one value per batch element, so `action_spec` (the
  JAX package's argument) changes nothing."""
  del action_spec
  return _sum_leaves(nest_utils.tree_map(
      lambda d, a: d.log_prob(a), distributions, actions,
      is_leaf=lambda x: hasattr(x, "log_prob")))


def entropy(distributions, action_spec=None):
  """Sum of per-leaf entropies over a nest of distributions (`action_spec`
  changes nothing, as in `log_probability`)."""
  del action_spec
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


def discounted_future_sum(values: torch.Tensor, gamma: float,
                          num_steps: int) -> torch.Tensor:
  """Windowed discounted sums over ``[B, T]`` values, zero-padded:
  ``out[:, t] = sum_{n < num_steps} gamma^n * values[:, t + n]``."""
  t = values.shape[1]
  padded = torch.nn.functional.pad(values, (0, num_steps - 1))
  powers = float(gamma) ** torch.arange(num_steps, dtype=values.dtype,
                                        device=values.device)
  idx = (torch.arange(t, device=values.device)[:, None]
         + torch.arange(num_steps, device=values.device)[None, :])
  return torch.sum(padded[:, idx] * powers, dim=-1)


def compute_returns(rewards: torch.Tensor, discounts: torch.Tensor,
                    time_major: bool = False) -> torch.Tensor:
  """Return-to-go per step of ``[T]``, ``[T, B]`` (time-major) or ``[B,
  T]`` rewards; `discounts` already include gamma."""
  from agents_tpu_torch.utils import value_ops
  if not time_major and rewards.dim() > 1:
    return value_ops.discounted_return(rewards, discounts, time_major=False)
  return value_ops.discounted_return(rewards, discounts, time_major=True)


class OUProcess:
  """Ornstein-Uhlenbeck noise as a function of (state, draws): each step
  draws a normal of the state's shape at `site`."""

  def __init__(self, spec_shape, damping: float = 0.15, stddev: float = 0.2,
               dtype=torch.float32):
    self.shape = tuple(spec_shape)
    self.damping = damping
    self.stddev = stddev
    self.dtype = dtype

  def init_state(self, batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros(tuple(batch_shape) + self.shape, dtype=self.dtype,
                       device=device)

  def step(self, state: torch.Tensor, draws, site: str = "ou_noise"):
    """(new state, noise): both ``(1 - damping) * state + stddev * eps``."""
    noise = draws.normal(site, tuple(state.shape), dtype=self.dtype)
    new_state = (1.0 - self.damping) * state + noise * self.stddev
    return new_state, new_state


def replicate(nest, outer_shape):
  """Every leaf broadcast to ``outer_shape + leaf.shape`` (a copy, so
  an in-place update of one replica leaves the others)."""
  outer = tuple(outer_shape)

  def _replicate(x):
    x = torch.as_tensor(x)
    return x.expand(outer + tuple(x.shape)).clone()

  return nest_utils.tree_map(_replicate, nest)
