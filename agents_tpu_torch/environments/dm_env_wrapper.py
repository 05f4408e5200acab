"""dm_env -> agents_tpu_torch adapter, and back.

Port of ``agents_tpu/environments/dm_env_wrapper.py`` (the reference's
``tf_agents/environments/dm_control_wrapper.py:33-140`` and
``py_to_dm_wrapper.py``): any environment conforming to the
``dm_env.Environment`` protocol (``reset()/step()/observation_spec()/
action_spec()`` returning ``dm_env.TimeStep`` / ``dm_env.specs.Array``-like
objects) is adapted to the port's host ``PyEnvironment`` surface (numpy
time steps). Both dm_control and bsuite environments speak dm_env, so
this single wrapper backs both suites.

The conversion is duck-typed (shape/dtype[/minimum/maximum] attributes)
so the adapter is testable without the dm_env package installed, and
``dm_env`` itself is imported only where the outbound adapter builds its
time steps and specs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from agents_tpu_torch.environments.py_environment import PyEnvironment
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import nest_utils


def _as_float32_array(x):
  return np.asarray(x, dtype=np.float32)


def _maybe_float32(o):
  o = np.asarray(o)
  if o.dtype == np.float64:
    return _as_float32_array(o)
  return o


def convert_spec(spec):
  """dm_env.specs.Array / BoundedArray -> ArraySpec / BoundedArraySpec,
  demoting float64 to float32 (reference convert_spec, :57-64)."""
  name = getattr(spec, "name", None)
  if hasattr(spec, "minimum") and hasattr(spec, "maximum"):
    out = array_spec.BoundedArraySpec(
        tuple(spec.shape), np.dtype(spec.dtype).type,
        minimum=spec.minimum, maximum=spec.maximum, name=name)
  else:
    out = array_spec.ArraySpec(tuple(spec.shape), np.dtype(spec.dtype).type,
                               name=name)
  if out.dtype == np.float64:
    out = out.replace(dtype=np.float32)
  return out


def convert_time_step(time_step) -> ts.TimeStep:
  """dm_env.TimeStep -> the port's TimeStep (reference convert_time_step,
  :39-54). dm_env emits reward=None/discount=None on the restart step."""
  reward = time_step.reward
  if reward is None:
    reward = 0.0
  discount = time_step.discount
  if discount is None:
    discount = 1.0
  observation = nest_utils.tree_map(_maybe_float32,
                                         time_step.observation)
  # dm_env.StepType has the same FIRST/MID/LAST = 0/1/2 encoding.
  return ts.TimeStep(
      step_type=np.asarray(int(time_step.step_type), np.int32),
      reward=_as_float32_array(reward),
      discount=_as_float32_array(discount),
      observation=observation)


class DmEnvWrapper(PyEnvironment):
  """Wraps a dm_env.Environment-conforming object."""

  def __init__(self, env, render_kwargs: Optional[dict] = None):
    super().__init__()
    self._env = env
    self._render_kwargs = render_kwargs or {}
    self._observation_spec = nest_utils.tree_map(
        convert_spec, env.observation_spec())
    self._action_spec = nest_utils.tree_map(
        convert_spec, env.action_spec())

  @property
  def physics(self):
    return getattr(self._env, "physics", None)

  def observation_spec(self):
    return self._observation_spec

  def action_spec(self):
    return self._action_spec

  def _reset(self) -> ts.TimeStep:
    return convert_time_step(self._env.reset())

  def _step(self, action) -> ts.TimeStep:
    action = nest_utils.tree_map(
        lambda a, s: np.asarray(a, dtype=s.dtype),
        action, self._env.action_spec())
    return convert_time_step(self._env.step(action))

  def close(self):
    if hasattr(self._env, "close"):
      self._env.close()

  def render(self, mode="rgb_array"):
    if mode != "rgb_array":
      raise ValueError(
          f"Only rgb_array rendering mode is supported. Got {mode}")
    physics = self.physics
    if physics is None:
      raise NotImplementedError("wrapped env exposes no physics to render")
    return physics.render(**self._render_kwargs)


# -- outbound adapter: PyEnvironment -> dm_env ------------------------------

class _DmTimeStep(tuple):
  """Duck-typed dm_env.TimeStep (step_type, reward, discount, observation)
  with first()/mid()/last() — used when the dm_env package is absent so
  the outbound adapter remains importable and testable."""

  def __new__(cls, step_type, reward, discount, observation):
    return tuple.__new__(cls, (step_type, reward, discount, observation))

  step_type = property(lambda self: self[0])
  reward = property(lambda self: self[1])
  discount = property(lambda self: self[2])
  observation = property(lambda self: self[3])

  def first(self):
    return self.step_type == 0

  def mid(self):
    return self.step_type == 1

  def last(self):
    return self.step_type == 2


def _to_dm_time_step(time_step: ts.TimeStep):
  """The port's TimeStep -> dm_env.TimeStep (reference
  py_to_dm_wrapper._convert_timestep, :29-43): FIRST steps carry
  reward=0.0/discount=1.0 exactly as the reference emits them (dm_env
  itself allows None on FIRST, but consumers ported from the reference
  accumulate ts.reward without a None check)."""
  try:
    import dm_env
    make = dm_env.TimeStep
    steptype = dm_env.StepType
  except ImportError:
    make = _DmTimeStep
    steptype = ts.StepType
  st = int(np.asarray(time_step.step_type))
  if st == int(ts.StepType.FIRST):
    return make(steptype.FIRST if hasattr(steptype, "FIRST") else 0,
                np.float32(0.0), np.float32(1.0), time_step.observation)
  dm_st = (steptype.LAST if st == int(ts.StepType.LAST)
           else steptype.MID) if hasattr(steptype, "LAST") else st
  return make(dm_st, np.asarray(time_step.reward),
              np.asarray(time_step.discount), time_step.observation)


def _to_dm_spec(spec):
  """ArraySpec / BoundedArraySpec -> dm_env.specs (duck-typed passthrough
  when dm_env is absent; our specs already expose shape/dtype/min/max)."""
  try:
    from dm_env import specs as dm_specs
  except ImportError:
    return spec
  if hasattr(spec, "minimum"):
    return dm_specs.BoundedArray(spec.shape, spec.dtype,
                                 minimum=spec.minimum,
                                 maximum=spec.maximum,
                                 name=getattr(spec, "name", None))
  return dm_specs.Array(spec.shape, spec.dtype,
                        name=getattr(spec, "name", None))


class PyToDmWrapper:
  """Expose a host PyEnvironment as a dm_env.Environment
  (reference ``environments/py_to_dm_wrapper.PyToDMWrapper`` :86-122):
  the outbound interop direction, so the port's envs plug into dm_env
  consumers (dm_control viewers, bsuite experiment runners)."""

  def __init__(self, env: PyEnvironment):
    if getattr(env, "batched", False):
      # Even batch_size==1 emits a leading (1,) dim on every leaf while
      # the specs stay per-env — a dm_env consumer validating
      # observations against observation_spec() would fail on shape.
      raise ValueError(
          "PyToDmWrapper requires an unbatched environment (dm_env has "
          f"no batch dimension); got batch_size={env.batch_size}. Wrap "
          "a single underlying env instead.")
    self._env = env

  def __getattr__(self, name):
    return getattr(self._env, name)

  def reset(self):
    return _to_dm_time_step(self._env.reset())

  def step(self, action):
    return _to_dm_time_step(self._env.step(action))

  def observation_spec(self):
    return nest_utils.tree_map(_to_dm_spec,
                                  self._env.observation_spec())

  def action_spec(self):
    return nest_utils.tree_map(_to_dm_spec, self._env.action_spec())

  def reward_spec(self):
    return nest_utils.tree_map(_to_dm_spec, self._env.reward_spec())

  def discount_spec(self):
    try:
      from dm_env import specs as dm_specs
      return dm_specs.BoundedArray((), np.float32, 0.0, 1.0, "discount")
    except ImportError:
      return array_spec.BoundedArraySpec((), np.float32, 0.0, 1.0,
                                         "discount")

  def close(self):
    self._env.close()
