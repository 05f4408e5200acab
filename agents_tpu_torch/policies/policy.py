"""Policy base: functions over (params, time_step, state, draws).

Port of ``agents_tpu/policies/policy.py``. Parameters are an explicit
argument, as in the JAX package; here they are the network module itself
(or a dict holding it), so target and behaviour copies are just different
modules. Randomness comes from an explicit draw source
(`agents_tpu_torch.utils.draws`) in place of a PRNG key.
"""
from __future__ import annotations

import abc
from typing import Optional

import torch

from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import nest_utils


def clip_to_spec(action, spec):
  """Clip continuous actions into bounded specs.

  Bounds that are one number over the spec's shape clip as Python floats,
  so the clip copies nothing to the device; per-element bounds are copied
  over at each call.
  """

  def _clip(a, s):
    if isinstance(s, array_spec.BoundedArraySpec) and \
        array_spec.is_continuous(s):
      lo, hi = s.minimum, s.maximum
      if lo.size == 1 and hi.size == 1:
        return torch.clamp(a, float(lo.flat[0]), float(hi.flat[0]))
      lo = torch.as_tensor(lo, dtype=a.dtype, device=a.device)
      hi = torch.as_tensor(hi, dtype=a.dtype, device=a.device)
      return torch.clamp(a, lo, hi)
    return a

  return nest_utils.tree_map(_clip, action, spec)


class Policy(abc.ABC):
  """Base policy.

  Attributes:
    time_step_spec / action_spec / info_spec / state_spec: spec nests.
  """

  def __init__(self, time_step_spec, action_spec, info_spec=(),
               state_spec=(), clip: bool = True):
    self.time_step_spec = time_step_spec
    self.action_spec = action_spec
    self.info_spec = info_spec
    self.state_spec = state_spec
    self.clip = clip

  def init_state(self, batch_size: Optional[int] = None, device=None):
    outer = () if batch_size is None else (batch_size,)
    return array_spec.zero_spec_nest(self.state_spec, outer_dims=outer,
                                     device=device)

  def _maybe_auto_reset(self, time_step: ts.TimeStep, state):
    """Zero the state rows whose time step is FIRST."""
    if state is None or (isinstance(state, tuple) and state == ()):
      return state
    zero = nest_utils.tree_map(torch.zeros_like, state)
    return nest_utils.where(time_step.is_first(), zero, state)

  def action(self, params, time_step: ts.TimeStep, state=(),
             draws=None) -> ps.PolicyStep:
    state = self._maybe_auto_reset(time_step, state)
    step = self._action(params, time_step, state, draws)
    if self.clip:
      step = step.replace(action=clip_to_spec(step.action, self.action_spec))
    return step

  def distribution(self, params, time_step: ts.TimeStep,
                   state=()) -> ps.PolicyStep:
    state = self._maybe_auto_reset(time_step, state)
    return self._distribution(params, time_step, state)

  def _action(self, params, time_step, state, draws) -> ps.PolicyStep:
    """Default: sample from `_distribution`."""
    dstep = self._distribution(params, time_step, state)
    action = nest_utils.tree_map(lambda d: d.sample(draws), dstep.action,
                                 is_leaf=lambda d: hasattr(d, "sample"))
    return ps.PolicyStep(action=action, state=dstep.state, info=dstep.info)

  @abc.abstractmethod
  def _distribution(self, params, time_step, state) -> ps.PolicyStep:
    ...
