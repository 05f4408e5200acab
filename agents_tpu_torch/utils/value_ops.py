"""Returns and advantages as reversed loops over time.

Port of ``agents_tpu/utils/value_ops.py`` (:16-91). Both quantities are
first-order linear recurrences ``y_t = a_t * y_{t+1} + b_t``; the JAX
package evaluates them with ``lax.associative_scan``, the port with a
reversed Python loop over T on device tensors, one `addcmul` per step and
one `stack` at the end. The loop reads no value back, so it makes no host
sync.
"""
from __future__ import annotations

from typing import Optional

import torch


def reverse_linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve y_t = a_t * y_{t+1} + b_t with y_T = 0, along dim 0."""
  acc = b[-1]
  out = [acc]
  for t in range(b.shape[0] - 2, -1, -1):
    acc = torch.addcmul(b[t], a[t], acc)
    out.append(acc)
  out.reverse()
  return torch.stack(out)


def discounted_return(rewards: torch.Tensor, discounts: torch.Tensor,
                      final_value: Optional[torch.Tensor] = None,
                      time_major: bool = True,
                      provide_all_returns: bool = True) -> torch.Tensor:
  """``G_t = r_t + d_t * G_{t+1}``, with ``G_T`` bootstrapped from
  `final_value` (or 0). `discounts` already include gamma.

  Args:
    rewards: [T, B] (time_major) or [B, T].
    discounts: same shape as rewards.
    final_value: [B] bootstrap value, zeros when None.
    time_major: axis layout.
    provide_all_returns: if False, return only G_0 (shape [B]).
  """
  if not time_major:
    rewards, discounts = rewards.transpose(0, 1), discounts.transpose(0, 1)
  if final_value is None:
    bootstrap = torch.zeros_like(rewards[-1])
  else:
    bootstrap = final_value.to(rewards.dtype)
  # The bootstrap folds into the last step's additive term, as in the JAX
  # package.
  b = torch.cat([rewards[:-1], (rewards[-1] + discounts[-1] * bootstrap)[None]])
  returns = reverse_linear_scan(discounts, b)
  if not provide_all_returns:
    return returns[0]
  if not time_major:
    returns = returns.transpose(0, 1)
  return returns


def generalized_advantage_estimation(values: torch.Tensor,
                                     final_value: torch.Tensor,
                                     discounts: torch.Tensor,
                                     rewards: torch.Tensor,
                                     td_lambda: float = 1.0,
                                     time_major: bool = True) -> torch.Tensor:
  """GAE(lambda) advantages:

      delta_t = r_t + d_t * V_{t+1} - V_t
      A_t = delta_t + lambda * d_t * A_{t+1}

  Args:
    values: [T, B] state values V_t (or [B, T] when not time_major).
    final_value: [B] value of the state after the last step (V_T).
    discounts: [T, B] discounts (already including gamma).
    rewards: [T, B].
    td_lambda: lambda mixing parameter.
    time_major: axis layout.
  """
  if not time_major:
    values, discounts, rewards = (x.transpose(0, 1)
                                  for x in (values, discounts, rewards))
  next_values = torch.cat([values[1:], final_value[None]], dim=0)
  deltas = rewards + discounts * next_values - values
  advantages = reverse_linear_scan(td_lambda * discounts, deltas)
  if not time_major:
    advantages = advantages.transpose(0, 1)
  return advantages
