"""The host environment layer of the PyTorch port against the JAX
package's, side by side on the same seeds and the same actions:
`PyEnvironment`'s auto-reset protocol, `CountingPyEnv`,
`RandomPyEnvironment` (a nested observation spec, drawn in the JAX
package's sorted-key order), `validate_py_environment`, gymnasium's
CartPole and Pendulum through `suite_gym.load`, `TimeLimit`,
`ActionRepeat`, `RunStats`, `HistoryWrapper`, `ActionDiscretizeWrapper`,
`BatchedPyEnvironment` (per-row auto-reset, thread pool) and
`ParallelPyEnvironment` in blocking and overlapped mode. These envs are
numpy throughout, so every time step is compared exactly.
"""
import functools

import jax
import numpy as np
import pytest

from agents_tpu import specs as jspecs
from agents_tpu.environments import suite_gym as jsuite_gym
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
from agents_tpu.environments.utils import \
    validate_py_environment as j_validate
from agents_tpu_torch.environments import suite_gym, wrappers
from agents_tpu_torch.environments.batched_py_environment import \
    BatchedPyEnvironment
from agents_tpu_torch.environments.parallel_py_environment import \
    ParallelPyEnvironment
from agents_tpu_torch.environments.py_environment import (PyEnvironment,
                                                          np_restart,
                                                          np_transition)
from agents_tpu_torch.environments.test_envs import (CountingPyEnv,
                                                     RandomPyEnvironment)
from agents_tpu_torch.environments.utils import validate_py_environment
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import nest_utils


def jax_leaves(nest):
  return jax.tree_util.tree_leaves(nest)


def assert_same_step(tstep, jstep, msg=""):
  """Equal time steps, leaf by leaf in the JAX package's order, dtypes
  included."""
  for field in ("step_type", "reward", "discount", "observation"):
    tl = nest_utils.flatten_sorted(getattr(tstep, field))
    jl = jax_leaves(getattr(jstep, field))
    assert len(tl) == len(jl), f"{msg} {field}"
    for a, b in zip(tl, jl):
      a, b = np.asarray(a), np.asarray(b)
      assert a.dtype == b.dtype, f"{msg} {field}: {a.dtype} vs {b.dtype}"
      np.testing.assert_array_equal(a, b, err_msg=f"{msg} {field}")


def to_jax_spec(spec):
  """A port spec nest as the JAX package's."""
  def one(s):
    if isinstance(s, tspec.BoundedArraySpec):
      return jspecs.BoundedArraySpec(s.shape, s.dtype, s.minimum, s.maximum,
                                     s.name)
    return jspecs.ArraySpec(s.shape, s.dtype, s.name)
  return tspec.map_spec_nest(one, spec)


def step_both(tenv, jenv, actions, msg=""):
  """Reset both envs, then step each with the same actions; every time
  step equal. Returns the port's time steps."""
  out = [tenv.reset()]
  assert_same_step(out[0], jenv.reset(), f"{msg} reset")
  for i, a in enumerate(actions):
    out.append(tenv.step(a))
    assert_same_step(out[-1], jenv.step(a), f"{msg} step {i}")
  return out


def test_counting_env_protocol_matches_jax():
  steps = step_both(CountingPyEnv(steps_per_episode=2),
                    JaxCounting(steps_per_episode=2), [0] * 7)
  types = [int(s.step_type) for s in steps]
  assert types == [0, 1, 2, 0, 1, 2, 0, 1]
  assert float(steps[2].discount) == 0.0
  assert int(steps[3].observation) == 10        # episode 1, after auto-reset


def test_auto_reset_opt_out_matches_jax():
  class Manual(CountingPyEnv):
    def __init__(self):
      super().__init__(2)
      self._handle_auto_reset = False

  class JaxManual(JaxCounting):
    def __init__(self):
      super().__init__(2)
      self._handle_auto_reset = False

  steps = step_both(Manual(), JaxManual(), [0] * 4)
  # No reset after LAST: the counting env runs on past its end.
  assert [int(s.step_type) for s in steps] == [0, 1, 2, 2, 2]


NESTED_OBS = {"pos": tspec.BoundedArraySpec((3,), np.float32, -2.0, 2.0),
              "count": tspec.BoundedArraySpec((), np.int32, 0, 9),
              "free": tspec.ArraySpec((2,), np.float64)}


@pytest.mark.parametrize("obs_spec", [
    tspec.ArraySpec((3,), np.float32), NESTED_OBS],
    ids=["flat", "dict"])
def test_random_env_matches_jax(obs_spec):
  act = tspec.BoundedArraySpec((), np.int32, 0, 3)
  kw = dict(episode_end_probability=0.3, min_duration=2, max_duration=6,
            seed=5)
  tenv = RandomPyEnvironment(obs_spec, act, **kw)
  jenv = JaxRandomPyEnvironment(to_jax_spec(obs_spec), to_jax_spec(act), **kw)
  steps = step_both(tenv, jenv, [np.int32(1)] * 30)
  assert any(int(s.step_type) == ts.StepType.LAST for s in steps)
  assert tspec.check_arrays_nest(steps[1].observation, obs_spec)


def test_validate_py_environment_matches_jax():
  assert validate_py_environment(CountingPyEnv(), episodes=2)
  assert j_validate(JaxCounting(), episodes=2)
  obs, act = tspec.ArraySpec((3,), np.float32), tspec.BoundedArraySpec(
      (), np.int32, 0, 3)
  assert validate_py_environment(
      RandomPyEnvironment(obs, act, episode_end_probability=0.3), episodes=2)

  class BadObs(CountingPyEnv):
    def observation_spec(self):
      return tspec.ArraySpec((2,), np.int32)

  with pytest.raises(ValueError, match="shape"):
    validate_py_environment(BadObs(), episodes=1)


@pytest.mark.parametrize("name,actions", [
    ("CartPole-v1", [np.asarray(a, np.int64) for a in [1, 0, 1, 1] * 80]),
    ("Pendulum-v1", [np.asarray([v], np.float32)
                     for v in np.linspace(-2, 2, 250)]),
], ids=["cartpole", "pendulum"])
def test_gym_envs_match_jax_under_the_same_actions(name, actions):
  tenv, jenv = suite_gym.load(name), jsuite_gym.load(name)
  assert repr(tenv.action_spec()) == repr(jenv.action_spec())
  assert repr(tenv.observation_spec()) == repr(jenv.observation_spec())
  tenv.seed(3)
  jenv.seed(3)
  steps = step_both(tenv, jenv, actions, name)
  # Both episodes end (CartPole falls, Pendulum's 200-step limit truncates
  # with discount 1) and auto-reset.
  lasts = [s for s in steps if int(s.step_type) == ts.StepType.LAST]
  assert lasts
  if name == "Pendulum-v1":
    assert float(lasts[0].discount) == 1.0
  else:
    assert float(lasts[0].discount) == 0.0
  tenv.close()
  jenv.close()


def test_time_limit_truncates_with_discount_one_matches_jax():
  steps = step_both(wrappers.TimeLimit(CountingPyEnv(100), duration=4),
                    jwrappers.TimeLimit(JaxCounting(100), duration=4), [0] * 6)
  assert int(steps[3].step_type) == ts.StepType.MID
  assert int(steps[4].step_type) == ts.StepType.LAST
  assert float(steps[4].discount) == 1.0


def test_action_repeat_sums_rewards_matches_jax():
  steps = step_both(wrappers.ActionRepeat(CountingPyEnv(10), times=3),
                    jwrappers.ActionRepeat(JaxCounting(10), times=3), [0] * 4)
  assert float(steps[1].reward) == 3.0


def test_run_stats_match_jax():
  tenv = wrappers.RunStats(CountingPyEnv(2))
  jenv = jwrappers.RunStats(JaxCounting(2))
  step_both(tenv, jenv, [0] * 6)
  assert (tenv.episodes, tenv.total_steps, tenv.resets) == (
      jenv.episodes, jenv.total_steps, jenv.resets)
  assert tenv.episodes >= 1 and tenv.total_steps >= 4


@pytest.mark.parametrize("tile", [False, True])
def test_history_wrapper_stacks_as_jax(tile):
  kw = dict(history_length=3, tile_first_step_obs=tile)
  steps = step_both(wrappers.HistoryWrapper(CountingPyEnv(5), **kw),
                    jwrappers.HistoryWrapper(JaxCounting(5), **kw), [0] * 7)
  assert steps[0].observation.shape == (3,)
  np.testing.assert_array_equal(steps[1].observation, [0, 0, 1])


def test_history_wrapper_with_actions_matches_jax():
  kw = dict(history_length=2, include_actions=True)
  steps = step_both(wrappers.HistoryWrapper(CountingPyEnv(3), **kw),
                    jwrappers.HistoryWrapper(JaxCounting(3), **kw),
                    [np.asarray(1, np.int32)] * 5)
  assert set(steps[2].observation) == {"observation", "action"}


class _ContEnv(PyEnvironment):
  def observation_spec(self):
    return tspec.ArraySpec((1,), np.float32)

  def action_spec(self):
    return tspec.BoundedArraySpec((), np.float32, -1.0, 1.0)

  def _reset(self):
    return np_restart(np.zeros(1, np.float32))

  def _step(self, action):
    self.last_action = float(action)
    return np_transition(np.full(1, action, np.float32),
                         np.asarray(0.0, np.float32))


class _JaxContEnv(JaxPyEnvironment):
  def observation_spec(self):
    return jspecs.ArraySpec((1,), np.float32)

  def action_spec(self):
    return jspecs.BoundedArraySpec((), np.float32, -1.0, 1.0)

  def _reset(self):
    return j_restart(np.zeros(1, np.float32))

  def _step(self, action):
    self.last_action = float(action)
    return j_transition(np.full(1, action, np.float32),
                        np.asarray(0.0, np.float32))


def test_action_discretize_matches_jax():
  tenv = wrappers.ActionDiscretizeWrapper(_ContEnv(), num_actions=5)
  jenv = jwrappers.ActionDiscretizeWrapper(_JaxContEnv(), num_actions=5)
  assert tenv.action_spec().num_values == jenv.action_spec().num_values == 5
  step_both(tenv, jenv, [np.asarray(a, np.int32) for a in (0, 4, 2, 1)])
  assert tenv.wrapped_env.last_action == jenv.wrapped_env.last_action == -0.5


@pytest.mark.parametrize("multithreading", [True, False])
def test_batched_py_environment_matches_jax(multithreading):
  tenv = BatchedPyEnvironment([CountingPyEnv(2 + i) for i in range(3)],
                              multithreading=multithreading)
  jenv = JaxBatchedPyEnvironment([JaxCounting(2 + i) for i in range(3)],
                                 multithreading=multithreading)
  assert tenv.batch_size == jenv.batch_size == 3
  steps = step_both(tenv, jenv, [np.zeros(3, np.int32)] * 5)
  assert steps[0].observation.shape == (3,)
  # Row 0 (2-step episodes) is LAST first and resets alone.
  assert list(steps[2].step_type) == [2, 1, 1]
  assert list(steps[3].step_type) == [0, 2, 1]
  tenv.close()
  jenv.close()


def test_batched_gym_pendulum_matches_jax():
  tenv = BatchedPyEnvironment([suite_gym.load("Pendulum-v1")
                               for _ in range(3)])
  jenv = JaxBatchedPyEnvironment([jsuite_gym.load("Pendulum-v1")
                                  for _ in range(3)])
  tenv.seed(11)
  jenv.seed(11)
  rng = np.random.RandomState(0)
  step_both(tenv, jenv, [rng.uniform(-2, 2, (3, 1)).astype(np.float32)
                         for _ in range(20)])
  with pytest.raises(ValueError):
    tenv.seed([1, 2])
  tenv.close()
  jenv.close()


@pytest.mark.parametrize("blocking", [True, False],
                         ids=["blocking", "overlapped"])
def test_parallel_env_equals_batched(blocking):
  """The process-parallel env steps exactly as the thread-batched one of
  the same seeds, in blocking (serial) and overlapped (promise) mode, and
  closes its workers."""
  obs = {"x": tspec.BoundedArraySpec((2,), np.float32, -1, 1),
         "k": tspec.BoundedArraySpec((), np.int32, 0, 5)}
  act = tspec.BoundedArraySpec((), np.int32, 0, 1)
  ctors = [functools.partial(RandomPyEnvironment, obs, act,
                             episode_end_probability=0.25, seed=s)
           for s in range(3)]
  penv = ParallelPyEnvironment(ctors, blocking=blocking)
  benv = BatchedPyEnvironment([c() for c in ctors])
  try:
    assert penv.batch_size == 3
    assert repr(penv.observation_spec()) == repr(benv.observation_spec())
    steps = [(penv.reset(), benv.reset())]
    for _ in range(12):
      a = np.ones(3, np.int32)
      steps.append((penv.step(a), benv.step(a)))
    for p, b in steps:
      for x, y in zip(nest_utils.flatten(p), nest_utils.flatten(b)):
        np.testing.assert_array_equal(x, y)
    assert penv.start_methods == ["fork"] * 3   # CUDA is not initialized
  finally:
    penv.close()
    benv.close()
  assert penv.workers_alive == 0


def test_parallel_env_raises_a_worker_error():
  def bad():
    raise ValueError("cannot build")

  with pytest.raises(RuntimeError, match="cannot build"):
    ParallelPyEnvironment([bad])
