"""Host environment validation.

Port of ``agents_tpu/environments/utils.py``: `validate_py_environment`
steps random actions and checks every time step's observation against the
specs.
"""
from __future__ import annotations

import numpy as np

from agents_tpu_torch.environments.py_environment import PyEnvironment
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import nest_utils


def validate_py_environment(environment: PyEnvironment, episodes: int = 5,
                            seed: int = 0):
  """Steps random actions (from ``RandomState(seed)``, in the JAX
  package's draw order) for `episodes` episodes; raises ValueError on an
  observation whose shape or dtype leaves its spec."""
  rng = np.random.RandomState(seed)
  time_step_spec = environment.time_step_spec()
  action_spec = environment.action_spec()
  batch_size = environment.batch_size if environment.batched else None

  def _sample_action():
    def _one(s):
      bounded = isinstance(s, array_spec.BoundedArraySpec)
      if np.issubdtype(s.dtype, np.integer):
        lo = np.asarray(s.minimum) if bounded else 0
        hi = np.asarray(s.maximum) if bounded else 1
        out = rng.randint(lo, np.asarray(hi, np.int64) + 1, size=s.shape)
      else:
        lo = np.maximum(np.asarray(s.minimum, np.float64), -1e6)
        hi = np.minimum(np.asarray(s.maximum, np.float64), 1e6)
        out = rng.uniform(lo, hi, size=s.shape)
      out = np.asarray(out, s.dtype)
      if batch_size:
        out = np.stack([out] * batch_size)
      return out

    return array_spec.map_spec_nest_sorted(_one, action_spec)

  def _check(time_step):
    leaves = nest_utils.flatten_sorted(time_step.observation)
    spec_leaves = nest_utils.flatten_sorted(time_step_spec.observation,
                                            is_leaf=array_spec._is_spec)
    for leaf, spec in zip(leaves, spec_leaves):
      expected = ((batch_size,) if batch_size else ()) + spec.shape
      if tuple(np.shape(leaf)) != expected:
        raise ValueError(
            f"Observation shape {np.shape(leaf)} != spec {expected}")
      if np.dtype(np.asarray(leaf).dtype) != spec.dtype:
        raise ValueError(
            f"Observation dtype {np.asarray(leaf).dtype} != {spec.dtype}")

  episode_count = 0
  time_step = environment.reset()
  _check(time_step)
  while episode_count < episodes:
    time_step = environment.step(_sample_action())
    _check(time_step)
    if np.all(time_step.step_type == ts.StepType.LAST):
      episode_count += 1
  return True
