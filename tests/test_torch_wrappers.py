"""The port's host wrappers against the JAX package's, side by side on the
same envs and actions: every case of `tests/test_wrappers_extra.py`, and
`FixedLength`, `PerformanceProfiler`, `ActionClipWrapper`,
`ActionOffsetWrapper`, `FlattenObservationsWrapper`, `OneHotActionWrapper`,
`ObservationFilterWrapper` and `GoalReplayEnvWrapper`. The flatten
wrappers lay a dict observation or action out in the JAX package's
sorted-key order, whatever the dict's own order. Time steps are equal
exactly.
"""
import numpy as np
import pytest

from agents_tpu import specs as jspecs
from agents_tpu.environments import wrappers as jwrappers
from agents_tpu.environments.batched_py_environment import \
    BatchedPyEnvironment as JaxBatchedPyEnvironment
from agents_tpu.environments.py_environment import \
    PyEnvironment as JaxPyEnvironment
from agents_tpu.environments.py_environment import np_restart as j_restart
from agents_tpu.environments.py_environment import \
    np_transition as j_transition
from agents_tpu.environments.test_envs import CountingPyEnv as JaxCounting
from agents_tpu.environments.test_envs import \
    RandomPyEnvironment as JaxRandomPyEnvironment
from agents_tpu_torch.environments import wrappers
from agents_tpu_torch.environments.batched_py_environment import \
    BatchedPyEnvironment
from agents_tpu_torch.environments.py_environment import (PyEnvironment,
                                                          np_restart,
                                                          np_transition)
from agents_tpu_torch.environments.test_envs import (CountingPyEnv,
                                                     RandomPyEnvironment)
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as ts
from test_torch_py_environments import step_both, to_jax_spec

# Keys out of sorted order, so that insertion and sorted order differ.
NEST_ACTION = {"b": tspec.BoundedArraySpec((), np.float32, 0, 2),
               "a": tspec.BoundedArraySpec((2,), np.float32, -1, 1)}


def _nest_action_envs(spec=NEST_ACTION):
  """A port and a JAX env that record the action they were stepped with."""

  class NestActionEnv(PyEnvironment):
    def observation_spec(self):
      return tspec.ArraySpec((1,), np.float32)

    def action_spec(self):
      return spec

    def _reset(self):
      return np_restart(np.zeros(1, np.float32))

    def _step(self, action):
      self.last = action
      return np_transition(np.zeros(1, np.float32),
                           np.asarray(0., np.float32))

  class JaxNestActionEnv(JaxPyEnvironment):
    def observation_spec(self):
      return jspecs.ArraySpec((1,), np.float32)

    def action_spec(self):
      return to_jax_spec(spec)

    def _reset(self):
      return j_restart(np.zeros(1, np.float32))

    def _step(self, action):
      self.last = action
      return j_transition(np.zeros(1, np.float32),
                          np.asarray(0., np.float32))

  return NestActionEnv(), JaxNestActionEnv()


def test_flatten_action_wrapper_orders_dict_leaves_as_jax():
  tenv_inner, jenv_inner = _nest_action_envs()
  tenv = wrappers.FlattenActionWrapper(tenv_inner)
  jenv = jwrappers.FlattenActionWrapper(jenv_inner)
  assert tenv.action_spec().shape == jenv.action_spec().shape == (3,)
  np.testing.assert_array_equal(tenv.action_spec().minimum,
                                jenv.action_spec().minimum)
  np.testing.assert_array_equal(tenv.action_spec().maximum,
                                jenv.action_spec().maximum)
  step_both(tenv, jenv, [np.asarray([0.5, -0.5, 1.5], np.float32)])
  # Sorted keys: "a" takes the first two columns although "b" comes first.
  np.testing.assert_array_equal(tenv.wrapped_env.last["a"], [0.5, -0.5])
  np.testing.assert_array_equal(tenv.wrapped_env.last["b"], 1.5)
  for k in ("a", "b"):
    np.testing.assert_array_equal(tenv.wrapped_env.last[k],
                                  jenv.wrapped_env.last[k])
  assert list(tenv.wrapped_env.last) == ["b", "a"]


def test_flatten_observations_orders_dict_leaves_as_jax():
  obs = {"z": tspec.BoundedArraySpec((2,), np.float32, -1, 1),
         "m": tspec.BoundedArraySpec((3,), np.float32, 0, 1),
         "a": tspec.BoundedArraySpec((), np.float32, 5, 6)}
  act = tspec.BoundedArraySpec((), np.int32, 0, 1)
  kw = dict(episode_end_probability=0.2, seed=3)
  tenv = wrappers.FlattenObservationsWrapper(
      RandomPyEnvironment(obs, act, **kw))
  jenv = jwrappers.FlattenObservationsWrapper(
      JaxRandomPyEnvironment(to_jax_spec(obs), to_jax_spec(act), **kw))
  assert tenv.observation_spec().shape == (6,)
  steps = step_both(tenv, jenv, [np.int32(0)] * 10)
  # Column 0 is "a" (in [5, 6]), then "m" (in [0, 1]), then "z".
  assert 5.0 <= steps[1].observation[0] <= 6.0
  assert np.all((steps[1].observation[1:4] >= 0.0)
                & (steps[1].observation[1:4] <= 1.0))


def test_flatten_observations_allowlist_matches_jax():
  obs = {"z": tspec.BoundedArraySpec((2,), np.float32, -1, 1),
         "m": tspec.BoundedArraySpec((3,), np.float32, 0, 1)}
  act = tspec.BoundedArraySpec((), np.int32, 0, 1)
  tenv = wrappers.FlattenObservationsWrapper(
      RandomPyEnvironment(obs, act, seed=1), observations_allowlist=["z"])
  jenv = jwrappers.FlattenObservationsWrapper(
      JaxRandomPyEnvironment(to_jax_spec(obs), to_jax_spec(act), seed=1),
      observations_allowlist=["z"])
  assert tenv.observation_spec().shape == (2,)
  step_both(tenv, jenv, [np.int32(0)] * 4)


def test_extra_disabled_actions_match_jax():
  tenv = wrappers.ExtraDisabledActionsWrapper(CountingPyEnv(), 3)
  jenv = jwrappers.ExtraDisabledActionsWrapper(JaxCounting(), 3)
  assert tenv.action_spec().num_values == 5
  steps = step_both(tenv, jenv, [np.asarray(1)])
  np.testing.assert_array_equal(steps[0].observation["valid_actions"],
                                [True, True, False, False, False])
  with pytest.raises(ValueError):
    tenv.step(np.asarray(4))
  with pytest.raises(ValueError):
    jenv.step(np.asarray(4))


def test_time_limit_batched_per_row_matches_jax():
  """Rows hit the limit on their own; a freshly reset FIRST row is never
  stamped LAST and every LAST is followed by a FIRST."""
  tenv = wrappers.TimeLimit(
      BatchedPyEnvironment([CountingPyEnv(3), CountingPyEnv(100)]), 5)
  jenv = jwrappers.TimeLimit(
      JaxBatchedPyEnvironment([JaxCounting(3), JaxCounting(100)]), 5)
  steps = step_both(tenv, jenv, [np.zeros(2, np.int32)] * 9)
  types = np.stack([s.step_type for s in steps[1:]])        # [T, 2]
  assert types[4, 1] == ts.StepType.LAST
  assert types[5, 1] == ts.StepType.FIRST
  assert np.all(types[6:10, 1] == ts.StepType.MID)
  for row in range(2):
    for t in range(1, len(types)):
      if types[t - 1, row] == ts.StepType.LAST:
        assert types[t, row] == ts.StepType.FIRST
      if types[t - 1, row] == ts.StepType.FIRST:
        assert types[t, row] != ts.StepType.LAST


class _Offset(CountingPyEnv):
  def _reset(self):
    step = super()._reset()
    return step.replace(observation=step.observation + 7)

  def _step(self, action):
    step = super()._step(action)
    return step.replace(observation=step.observation + 7)


class _JaxOffset(JaxCounting):
  def _reset(self):
    step = super()._reset()
    return step.replace(observation=step.observation + 7)

  def _step(self, action):
    step = super()._step(action)
    return step.replace(observation=step.observation + 7)


@pytest.mark.parametrize("tile,first", [(False, [0, 0, 7]),
                                        (True, [7, 7, 7])])
def test_history_wrapper_padding_matches_jax(tile, first):
  kw = dict(history_length=3, tile_first_step_obs=tile)
  steps = step_both(wrappers.HistoryWrapper(_Offset(5), **kw),
                    jwrappers.HistoryWrapper(_JaxOffset(5), **kw), [0] * 8)
  np.testing.assert_array_equal(steps[0].observation, first)


def test_fixed_length_matches_jax():
  steps = step_both(wrappers.FixedLength(CountingPyEnv(2), 5),
                    jwrappers.FixedLength(JaxCounting(2), 5), [0] * 11)
  types = [int(s.step_type) for s in steps]
  assert types[:6] == [0, 1, 1, 1, 1, 2]


def test_performance_profiler_reports_every_n_steps():
  calls = []
  env = wrappers.PerformanceProfiler(CountingPyEnv(50),
                                     lambda s, n: calls.append((s, n)), 3)
  jenv = jwrappers.PerformanceProfiler(JaxCounting(50), lambda s, n: None, 3)
  step_both(env, jenv, [0] * 7)
  assert [n for _, n in calls] == [3, 3]
  assert all(s >= 0.0 for s, _ in calls)


class _BoundedEcho(PyEnvironment):
  """Observation = the (float) action it was stepped with."""

  def __init__(self, spec):
    super().__init__()
    self._spec = spec

  def observation_spec(self):
    return tspec.ArraySpec(self._spec.shape, np.float32)

  def action_spec(self):
    return self._spec

  def _reset(self):
    return np_restart(np.zeros(self._spec.shape, np.float32))

  def _step(self, action):
    return np_transition(np.asarray(action, np.float32),
                         np.asarray(0., np.float32))


class _JaxBoundedEcho(JaxPyEnvironment):
  def __init__(self, spec):
    super().__init__()
    self._spec = to_jax_spec(spec)

  def observation_spec(self):
    return jspecs.ArraySpec(self._spec.shape, np.float32)

  def action_spec(self):
    return self._spec

  def _reset(self):
    return j_restart(np.zeros(self._spec.shape, np.float32))

  def _step(self, action):
    return j_transition(np.asarray(action, np.float32),
                        np.asarray(0., np.float32))


def test_action_clip_matches_jax():
  spec = tspec.BoundedArraySpec((2,), np.float32, [-1, 0], [1, 2])
  steps = step_both(wrappers.ActionClipWrapper(_BoundedEcho(spec)),
                    jwrappers.ActionClipWrapper(_JaxBoundedEcho(spec)),
                    [np.asarray([-3.0, 5.0], np.float32)])
  np.testing.assert_array_equal(steps[1].observation, [-1.0, 2.0])


def test_action_offset_matches_jax():
  spec = tspec.BoundedArraySpec((), np.int32, 3, 6)
  tenv = wrappers.ActionOffsetWrapper(_BoundedEcho(spec))
  jenv = jwrappers.ActionOffsetWrapper(_JaxBoundedEcho(spec))
  assert int(tenv.action_spec().minimum) == 0
  assert int(tenv.action_spec().maximum) == 3
  steps = step_both(tenv, jenv, [np.int32(0), np.int32(3)])
  assert float(steps[2].observation) == 6.0


@pytest.mark.parametrize("shape", [(), (1,)])
def test_one_hot_action_matches_jax(shape):
  spec = tspec.BoundedArraySpec(shape, np.int32, 2, 5)
  tenv = wrappers.OneHotActionWrapper(_BoundedEcho(spec))
  jenv = jwrappers.OneHotActionWrapper(_JaxBoundedEcho(spec))
  assert tenv.action_spec().shape == (4,)
  steps = step_both(tenv, jenv, [np.asarray([0, 0, 1, 0], np.int32)])
  assert float(np.ravel(steps[1].observation)[0]) == 4.0


def test_observation_filter_matches_jax():
  spec = tspec.BoundedArraySpec((4,), np.float32, -1, 1)
  tenv = wrappers.ObservationFilterWrapper(_BoundedEcho(spec), [3, 1])
  jenv = jwrappers.ObservationFilterWrapper(_JaxBoundedEcho(spec), [3, 1])
  assert tenv.observation_spec().shape == (2,)
  steps = step_both(tenv, jenv, [np.asarray([.1, .2, .3, .4], np.float32)])
  np.testing.assert_array_equal(steps[1].observation,
                                np.asarray([.4, .2], np.float32))


def test_goal_replay_hooks_are_abstract():
  env = wrappers.GoalReplayEnvWrapper(CountingPyEnv())
  with pytest.raises(NotImplementedError):
    env.get_goal_from_trajectory(None)
  with pytest.raises(NotImplementedError):
    env.get_trajectory_with_goal(None, None)
  assert env.reset().observation == 0
