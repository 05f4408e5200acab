"""Uniform random, fixed and scripted actions.

Port of ``agents_tpu/policies/random_policy.py``: `FixedPolicy` and
`ScriptedPolicy` (:73-112) copy their action arrays to a device once, on
first use; `RandomPolicy` (:20-70) draws each action leaf uniformly from
its spec by
`array_spec.sample_spec_nest` at the draw site "random_policy". With
`emit_log_probability`, the info holds the uniform log-probability of the
whole action: minus the sum of ``log(maximum - minimum)`` over a
continuous leaf's elements, minus ``numel * log(num_values)`` over a
discrete one's (2 values for bool, 2^29 for an unbounded int).
"""
from __future__ import annotations

import numpy as np
import torch

from agents_tpu_torch import distributions as dist_lib
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
    super().__init__(time_step_spec, action_spec,
                     emit_log_probability=emit_log_probability, clip=False)
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


def _as_tensor_nest(nest, device):
  """`nest`'s arrays as tensors on `device`, 64-bit numbers narrowed to 32
  bits as the JAX package's default types narrow them."""
  narrow = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}

  def convert(a):
    a = np.asarray(a)
    return torch.as_tensor(a.astype(narrow.get(a.dtype, a.dtype)),
                           device=device)

  return nest_utils.tree_map(convert, nest)


class _PerDevice:
  """A nest of arrays copied to each device once, on first use."""

  def __init__(self, nest):
    self.nest = nest
    self._copies = {}

  def on(self, device):
    device = torch.device(device)
    if device not in self._copies:
      self._copies[device] = _as_tensor_nest(self.nest, device)
    return self._copies[device]


class FixedPolicy(Policy):
  """Always emits `action` (a nest), broadcast over the batch; its
  distribution is a `Deterministic` there."""

  def __init__(self, action, time_step_spec, action_spec):
    super().__init__(time_step_spec, action_spec, clip=False)
    self.fixed_action = action
    self._action_on = _PerDevice(action)

  def _action(self, params, time_step, state, draws):
    batch_shape = tuple(time_step.step_type.shape)
    action = nest_utils.tree_map(
        lambda a: a.expand(batch_shape + tuple(a.shape)),
        self._action_on.on(time_step.step_type.device))
    return ps.PolicyStep(action=action, state=state, info=())

  def _distribution(self, params, time_step, state):
    step = self._action(params, time_step, state, None)
    return step.replace(action=nest_utils.tree_map(dist_lib.Deterministic,
                                                   step.action))


class ScriptedPolicy(Policy):
  """Replays a recorded ``[T, ...]`` action table, indexed by a step
  counter carried in the policy state (an int32 per row, zeroed at FIRST
  steps); past the end it repeats the last row."""

  def __init__(self, time_step_spec, action_spec, action_script):
    super().__init__(time_step_spec, action_spec,
                     state_spec=array_spec.ArraySpec((), np.int32, "t"),
                     clip=False)
    self._script_on = _PerDevice(action_script)
    self.script_len = int(np.asarray(nest_utils.flatten(action_script)[0])
                          .shape[0])

  def _action(self, params, time_step, state, draws):
    t = state
    idx = torch.clamp(t, max=self.script_len - 1).long()
    action = nest_utils.tree_map(lambda s: s[idx],
                                 self._script_on.on(t.device))
    return ps.PolicyStep(action=action, state=t + 1, info=())

  def _distribution(self, params, time_step, state):
    raise NotImplementedError("ScriptedPolicy replays a table")
