"""Policy utilities: a background saver, info injection, action smoothing.

Port of ``agents_tpu/policies/policy_utils.py``: `AsyncPolicySaver` (a
`PolicySaver.save` on a background thread), `PolicyInfoUpdaterWrapper`
(extra fields merged into a dict info) and
`TemporalActionSmoothingPolicy` (an exponential moving average over
successive actions, kept in the policy state).
"""
from __future__ import annotations

import copy
import threading
from typing import Callable, Optional

import numpy as np
import torch

from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.utils import nest_utils


class AsyncPolicySaver:
  """Runs `PolicySaver.save` on a background thread. One save is in
  flight at a time; a request while one runs is dropped (returns False).
  The params are snapshotted (deep copies, on their devices) before the
  thread starts, so training may go on updating them in place."""

  def __init__(self, saver):
    self._saver = saver
    self._thread: Optional[threading.Thread] = None
    self._lock = threading.Lock()

  def save(self, export_dir: str, params) -> bool:
    with self._lock:
      if self._thread is not None and self._thread.is_alive():
        return False
      with torch.no_grad():
        params = copy.deepcopy(params)  # snapshot
      self._thread = threading.Thread(
          target=self._saver.save, args=(export_dir, params), daemon=True)
      self._thread.start()
      return True

  def flush(self):
    t = self._thread
    if t is not None:
      t.join()


class PolicyInfoUpdaterWrapper(Policy):
  """Merges ``updater_fn(policy_step)`` (a dict) into the wrapped policy's
  dict info."""

  def __init__(self, wrapped: Policy, updater_fn: Callable):
    super().__init__(wrapped.time_step_spec, wrapped.action_spec,
                     info_spec=wrapped.info_spec,
                     state_spec=wrapped.state_spec, clip=wrapped.clip)
    self.wrapped = wrapped
    self.updater_fn = updater_fn

  def _merge(self, step):
    extra = self.updater_fn(step)
    info = step.info
    if info == () or info is None:
      info = {}
    if not isinstance(info, dict):
      raise TypeError("PolicyInfoUpdaterWrapper requires dict info")
    return step.replace(info={**info, **extra})

  def _action(self, params, time_step, state, draws):
    return self._merge(self.wrapped._action(params, time_step, state, draws))

  def _distribution(self, params, time_step, state):
    return self._merge(self.wrapped._distribution(params, time_step, state))


class TemporalActionSmoothingPolicy(Policy):
  """``a_out = c * prev + (1 - c) * a`` per action leaf; the moving
  averages (float32) ride in the policy state beside the wrapped
  policy's, and restart from zero at FIRST steps."""

  def __init__(self, wrapped: Policy, smoothing_coefficient: float):
    action_leaves = nest_utils.flatten(wrapped.action_spec,
                                       is_leaf=array_spec._is_spec)
    ema_specs = tuple(array_spec.ArraySpec(s.shape, np.float32, "ema")
                      for s in action_leaves)
    super().__init__(wrapped.time_step_spec, wrapped.action_spec,
                     state_spec=(wrapped.state_spec, ema_specs),
                     clip=wrapped.clip)
    self.wrapped = wrapped
    self.c = smoothing_coefficient

  def init_state(self, batch_size=None, device=None):
    outer = () if batch_size is None else (batch_size,)
    return (self.wrapped.init_state(batch_size, device=device),
            array_spec.zero_spec_nest(self.state_spec[1], outer_dims=outer,
                                      device=device))

  def _action(self, params, time_step, state, draws):
    wrapped_state, ema = state
    step = self.wrapped._action(params, time_step, wrapped_state, draws)
    leaves = nest_utils.flatten(step.action)
    smoothed, new_ema = [], []
    for a, m in zip(leaves, ema, strict=True):
      out = self.c * m + (1.0 - self.c) * a.to(torch.float32)
      smoothed.append(out.to(a.dtype))
      new_ema.append(out)
    it = iter(smoothed)
    action = nest_utils.tree_map(lambda _: next(it), step.action)
    return ps.PolicyStep(action=action, state=(step.state, tuple(new_ema)),
                         info=step.info)

  def _distribution(self, params, time_step, state):
    raise NotImplementedError
