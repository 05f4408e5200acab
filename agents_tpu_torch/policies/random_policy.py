"""Uniform random actions.

Port of `RandomPolicy` of ``agents_tpu/policies/random_policy.py``
(:20-70): each action leaf is drawn uniformly from its spec by
`array_spec.sample_spec_nest` at the draw site "random_policy". With
`emit_log_probability`, the info holds the uniform log-probability of the
whole action: minus the sum of ``log(maximum - minimum)`` over a
continuous leaf's elements, minus ``numel * log(num_values)`` over a
discrete one's (2 values for bool, 2^29 for an unbounded int).
"""
from __future__ import annotations

import numpy as np
import torch

from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.utils import nest_utils

RANDOM_POLICY_SITE = "random_policy"


def _log_prob(spec) -> float:
  """The uniform log-probability of one sample of `spec`."""
  n_elems = float(np.prod(spec.shape)) if spec.shape else 1.0
  if not array_spec.is_continuous(spec):
    if np.dtype(spec.dtype) == np.bool_:
      num_values = 2.0
    elif isinstance(spec, array_spec.BoundedArraySpec):
      num_values = float(spec.num_values)
    else:
      num_values = float(2**29)
    return -n_elems * float(np.log(num_values))
  span = np.broadcast_to(
      np.asarray(spec.maximum, np.float64) - np.asarray(spec.minimum,
                                                         np.float64),
      spec.shape or (1,))
  return -float(np.sum(np.log(span)))


class RandomPolicy(Policy):

  def __init__(self, time_step_spec, action_spec,
               emit_log_probability: bool = False):
    super().__init__(time_step_spec, action_spec, clip=False)
    self.emit_log_probability = emit_log_probability
    self._log_probability = sum(
        _log_prob(s) for s in nest_utils.flatten(
            action_spec, is_leaf=array_spec._is_spec))

  def _action(self, params, time_step, state, draws):
    del params
    batch_shape = tuple(time_step.step_type.shape)
    action = array_spec.sample_spec_nest(self.action_spec, draws,
                                         outer_dims=batch_shape,
                                         site=RANDOM_POLICY_SITE)
    info = ()
    if self.emit_log_probability:
      info = ps.set_log_probability((), torch.full(
          batch_shape, self._log_probability, dtype=torch.float32,
          device=time_step.step_type.device))
    return ps.PolicyStep(action=action, state=state, info=info)

  def _distribution(self, params, time_step, state):
    raise NotImplementedError("RandomPolicy acts by direct sampling")
