"""Host environment wrappers.

Port of ``agents_tpu/environments/wrappers.py``, all 16 wrappers:
`PyEnvironmentBaseWrapper`, `TimeLimit`, `FixedLength`, `ActionRepeat`,
`RunStats`, `PerformanceProfiler`, `ActionDiscretizeWrapper`,
`ActionClipWrapper`, `ActionOffsetWrapper`, `FlattenObservationsWrapper`,
`HistoryWrapper`, `OneHotActionWrapper`, `ObservationFilterWrapper`,
`FlattenActionWrapper`, `ExtraDisabledActionsWrapper` and
`GoalReplayEnvWrapper`. The two flatten wrappers lay a dict observation or
action out in the JAX package's order, dict keys sorted
(`nest_utils.flatten_sorted`), so a network carried across from it reads
the same columns.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Optional, Sequence

import numpy as np

from agents_tpu_torch.environments.py_environment import PyEnvironment
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import nest_utils


class PyEnvironmentBaseWrapper(PyEnvironment):
  """Forwards everything to the wrapped env."""

  def __init__(self, env: PyEnvironment,
               handle_auto_reset: Optional[bool] = None):
    # Inherit the wrapped env's auto-reset opt-out by default: otherwise
    # TimeLimit(GymWrapper(env, auto_reset=False)) would re-enable
    # auto-reset at the wrapper.
    if handle_auto_reset is None:
      handle_auto_reset = getattr(env, "_handle_auto_reset", True)
    super().__init__(handle_auto_reset=handle_auto_reset)
    self._env = env

  @property
  def wrapped_env(self):
    return self._env

  @property
  def batched(self):
    return self._env.batched

  @property
  def batch_size(self):
    return self._env.batch_size

  def observation_spec(self):
    return self._env.observation_spec()

  def action_spec(self):
    return self._env.action_spec()

  def reward_spec(self):
    return self._env.reward_spec()

  def _reset(self):
    return self._env.reset()

  def _step(self, action):
    return self._env.step(action)

  def render(self, mode="rgb_array"):
    return self._env.render(mode)

  def seed(self, seed):
    return self._env.seed(seed)

  def close(self):
    return self._env.close()

  def get_info(self):
    return self._env.get_info()


class TimeLimit(PyEnvironmentBaseWrapper):
  """Truncates episodes after `duration` steps, row by row."""

  def __init__(self, env, duration: int):
    super().__init__(env)
    self._duration = duration
    self._num_steps = None
    self._pending_reset = None

  def _reset(self):
    time_step = self._env.reset()
    self._num_steps = np.zeros(np.shape(time_step.step_type), np.int64)
    self._pending_reset = np.zeros(np.shape(time_step.step_type), bool)
    return time_step

  def _step(self, action):
    if self._num_steps is None:
      return self._reset()
    time_step = self._env.step(action)
    st = np.asarray(time_step.step_type)
    # A row stamped LAST by truncation on the previous frame saw MID
    # underneath and kept its episode going, so from the agent's view this
    # frame starts a new episode: relabel it FIRST with a restart's reward
    # and discount. A row whose inner env did emit FIRST needs no relabel.
    # Should the inner episode terminate on exactly this frame, the
    # relabel drops that terminal, as a reset would have.
    if np.any(self._pending_reset):
      relabel = self._pending_reset & (st != ts.StepType.FIRST)
      if np.any(relabel):
        reward = np.asarray(time_step.reward)
        discount = np.asarray(time_step.discount)
        st = np.where(relabel, ts.StepType.FIRST, st).astype(st.dtype)
        time_step = time_step.replace(
            step_type=st,
            reward=np.where(relabel, np.zeros_like(reward), reward),
            discount=np.where(relabel, np.ones_like(discount), discount))
      self._pending_reset = np.zeros_like(self._pending_reset)
    # Per-row counts: a freshly reset FIRST row restarts its count, so no
    # FIRST frame is ever stamped LAST.
    self._num_steps = np.where(st == ts.StepType.FIRST, 0,
                               self._num_steps + 1)
    over = (self._num_steps >= self._duration) & (st == ts.StepType.MID)
    if np.any(over):
      time_step = time_step.replace(
          step_type=np.where(over, ts.StepType.LAST, st).astype(st.dtype))
      self._pending_reset = self._pending_reset | over
    return time_step

  @property
  def duration(self):
    return self._duration


class FixedLength(PyEnvironmentBaseWrapper):
  """Episodes of exactly `episode_length` frames: an early LAST becomes a
  MID over a reset of the env underneath."""

  def __init__(self, env, episode_length: int):
    super().__init__(env)
    self._length = episode_length
    self._count = 0

  def _reset(self):
    self._count = 0
    return self._env.reset()

  def _step(self, action):
    inner = self._env.step(action)
    self._count += 1
    if self._count >= self._length:
      self._count = 0
      if not np.all(inner.step_type == ts.StepType.LAST):
        return inner.replace(
            step_type=np.full_like(inner.step_type, ts.StepType.LAST))
      return inner
    if np.all(inner.step_type == ts.StepType.LAST):
      restarted = self._env.reset()
      return restarted.replace(
          step_type=np.full_like(inner.step_type, ts.StepType.MID),
          reward=inner.reward, discount=inner.discount)
    return inner


class ActionRepeat(PyEnvironmentBaseWrapper):
  """Repeats each action `times` times, summing the rewards; stops early
  at a LAST or FIRST."""

  def __init__(self, env, times: int):
    super().__init__(env)
    if times <= 1:
      raise ValueError("times must be > 1")
    self._times = times

  def _step(self, action):
    total_reward = 0.0
    time_step = None
    for _ in range(self._times):
      time_step = self._env.step(action)
      total_reward += np.asarray(time_step.reward)
      if np.any(time_step.step_type == ts.StepType.LAST) or np.any(
          time_step.step_type == ts.StepType.FIRST):
        break
    return time_step.replace(reward=np.asarray(total_reward, np.float32))


class RunStats(PyEnvironmentBaseWrapper):
  """Counts steps, episodes and resets."""

  def __init__(self, env):
    super().__init__(env)
    self.total_steps = 0
    self.episodes = 0
    self.resets = 0

  def _reset(self):
    self.resets += 1
    return self._env.reset()

  def _step(self, action):
    time_step = self._env.step(action)
    if np.all(time_step.step_type == ts.StepType.FIRST):
      self.resets += 1
    else:
      self.total_steps += 1
    if np.all(time_step.step_type == ts.StepType.LAST):
      self.episodes += 1
    return time_step


class PerformanceProfiler(PyEnvironmentBaseWrapper):
  """Sums the wall time of env steps and hands it with the step count to
  `process_profile_fn` every `process_steps` steps."""

  def __init__(self, env, process_profile_fn: Callable[[float, int], None],
               process_steps: int = 100):
    super().__init__(env)
    self._fn = process_profile_fn
    self._every = process_steps
    self._acc = 0.0
    self._n = 0

  def _step(self, action):
    t0 = time.perf_counter()
    out = self._env.step(action)
    self._acc += time.perf_counter() - t0
    self._n += 1
    if self._n >= self._every:
      self._fn(self._acc, self._n)
      self._acc, self._n = 0.0, 0
    return out


class ActionDiscretizeWrapper(PyEnvironmentBaseWrapper):
  """A continuous action spec as a grid of `num_actions` values per
  element."""

  def __init__(self, env, num_actions):
    super().__init__(env)
    spec = env.action_spec()
    if not array_spec.is_continuous(spec):
      raise ValueError("ActionDiscretizeWrapper requires a continuous spec")
    self._num_actions = np.broadcast_to(np.asarray(num_actions), spec.shape)
    lows = np.broadcast_to(spec.minimum, spec.shape)
    highs = np.broadcast_to(spec.maximum, spec.shape)
    self._action_map = [
        np.linspace(lo, hi, int(n))
        for lo, hi, n in zip(np.ravel(lows), np.ravel(highs),
                             np.ravel(self._num_actions))]
    if spec.shape == ():
      self._action_spec = array_spec.BoundedArraySpec(
          (), np.int32, 0, int(self._num_actions) - 1, name="action")
    else:
      self._action_spec = array_spec.BoundedArraySpec(
          spec.shape, np.int32, 0,
          (self._num_actions - 1).astype(np.int32), name="action")
    self._orig_shape = spec.shape
    self._orig_dtype = spec.dtype

  def action_spec(self):
    return self._action_spec

  def _step(self, action):
    flat = np.ravel(np.asarray(action))
    cont = np.array([m[int(a)] for m, a in zip(self._action_map, flat)],
                    dtype=self._orig_dtype).reshape(self._orig_shape)
    return self._env.step(cont)


class ActionClipWrapper(PyEnvironmentBaseWrapper):
  """Clips actions to the bounds of the action spec."""

  def _step(self, action):
    spec = self._env.action_spec()

    def _clip(s, a):
      if isinstance(s, array_spec.BoundedArraySpec):
        return np.clip(np.asarray(a), s.minimum, s.maximum)
      return a

    return self._env.step(array_spec.map_spec_nest(_clip, spec, action))


class ActionOffsetWrapper(PyEnvironmentBaseWrapper):
  """A discrete action spec shifted to start at 0."""

  def __init__(self, env):
    super().__init__(env)
    spec = env.action_spec()
    if not array_spec.is_discrete(spec):
      raise ValueError("ActionOffsetWrapper requires a discrete spec")
    self._offset = spec.minimum
    self._action_spec = array_spec.BoundedArraySpec(
        spec.shape, spec.dtype, 0, spec.maximum - spec.minimum,
        name=spec.name)

  def action_spec(self):
    return self._action_spec

  def _step(self, action):
    return self._env.step(np.asarray(action) + self._offset)


class FlattenObservationsWrapper(PyEnvironmentBaseWrapper):
  """The (allow-listed) observation leaves concatenated into one vector,
  in the JAX package's leaf order (dict keys sorted)."""

  def __init__(self, env, observations_allowlist: Optional[Sequence] = None):
    super().__init__(env)
    obs_spec = env.observation_spec()
    if observations_allowlist is not None:
      if not isinstance(obs_spec, dict):
        raise ValueError("allowlist requires dict observations")
      obs_spec = {k: obs_spec[k] for k in observations_allowlist}
    self._allowlist = observations_allowlist
    leaves = nest_utils.flatten_sorted(obs_spec, is_leaf=array_spec._is_spec)
    dtypes = {leaf.dtype for leaf in leaves}
    if len(dtypes) > 1:
      raise ValueError(f"Observations must share dtype, got {dtypes}")
    size = int(sum(np.prod(leaf.shape) for leaf in leaves))
    self._observation_spec = array_spec.ArraySpec(
        (size,), leaves[0].dtype, name="observation")

  def observation_spec(self):
    return self._observation_spec

  def _flatten(self, time_step):
    obs = time_step.observation
    if self._allowlist is not None:
      obs = {k: obs[k] for k in self._allowlist}
    flat = np.concatenate([np.ravel(leaf)
                           for leaf in nest_utils.flatten_sorted(obs)])
    return time_step.replace(
        observation=flat.astype(self._observation_spec.dtype))

  def _reset(self):
    return self._flatten(self._env.reset())

  def _step(self, action):
    return self._flatten(self._env.step(action))


class HistoryWrapper(PyEnvironmentBaseWrapper):
  """The last `history_length` observations (and, with `include_actions`,
  actions) concatenated on the last axis. Before an episode's first frame
  the history holds zero frames, or the first observation with
  `tile_first_step_obs`."""

  def __init__(self, env, history_length: int = 3,
               include_actions: bool = False, tile_first_step_obs=False):
    super().__init__(env)
    self._history_length = history_length
    self._include_actions = include_actions
    obs_spec = env.observation_spec()
    self._tile_first_step_obs = tile_first_step_obs
    self._obs_spec_single = obs_spec

    def stack(s):
      if s.shape:
        return s.replace(shape=s.shape[:-1] + (s.shape[-1] * history_length,))
      return s.replace(shape=(history_length,))

    self._observation_spec = array_spec.map_spec_nest(stack, obs_spec)
    if include_actions:
      self._observation_spec = {
          "observation": self._observation_spec,
          "action": array_spec.map_spec_nest(stack, env.action_spec()),
      }
    self._obs_history = collections.deque(maxlen=history_length)
    self._action_history = collections.deque(maxlen=history_length)

  def observation_spec(self):
    return self._observation_spec

  def _stack(self):
    concat = lambda *xs: np.concatenate(  # noqa: E731
        [np.atleast_1d(x) for x in xs], axis=-1)
    obs = nest_utils.tree_map(concat, *self._obs_history)
    if not self._include_actions:
      return obs
    return {"observation": obs,
            "action": nest_utils.tree_map(concat, *self._action_history)}

  def _zero_action(self):
    return array_spec.map_spec_nest(
        lambda s: np.zeros(s.shape, s.dtype), self._env.action_spec())

  def _zero_obs(self):
    return array_spec.map_spec_nest(
        lambda s: np.zeros(s.shape, s.dtype), self._obs_spec_single)

  def _restart_history(self, observation):
    self._obs_history.clear()
    self._action_history.clear()
    pad = observation if self._tile_first_step_obs else self._zero_obs()
    for _ in range(self._history_length - 1):
      self._obs_history.append(pad)
      self._action_history.append(self._zero_action())
    self._obs_history.append(observation)
    self._action_history.append(self._zero_action())

  def _reset(self):
    time_step = self._env.reset()
    self._restart_history(time_step.observation)
    return time_step.replace(observation=self._stack())

  def _step(self, action):
    time_step = self._env.step(action)
    if np.all(time_step.step_type == ts.StepType.FIRST):
      # The env underneath reset itself.
      self._restart_history(time_step.observation)
      return time_step.replace(observation=self._stack())
    self._obs_history.append(time_step.observation)
    self._action_history.append(np.asarray(action))
    return time_step.replace(observation=self._stack())


class OneHotActionWrapper(PyEnvironmentBaseWrapper):
  """Takes one-hot actions and forwards their argmax."""

  def __init__(self, env):
    super().__init__(env)
    spec = env.action_spec()
    if not array_spec.is_discrete(spec) or spec.shape not in ((), (1,)):
      raise ValueError("OneHotActionWrapper requires scalar discrete spec")
    self._inner_spec = spec
    self._action_spec = array_spec.BoundedArraySpec(
        (spec.num_values,), np.int32, 0, 1, name="one_hot_action")

  def action_spec(self):
    return self._action_spec

  def _step(self, action):
    idx = np.argmax(np.asarray(action), axis=-1).astype(
        self._inner_spec.dtype)
    idx = idx + self._inner_spec.minimum
    # A shape-(1,) inner spec gets an action of that shape.
    if self._inner_spec.shape == (1,):
      idx = np.reshape(idx, np.shape(idx) + (1,))
    return self._env.step(idx)


class ObservationFilterWrapper(PyEnvironmentBaseWrapper):
  """Keeps the given indices of a flat observation."""

  def __init__(self, env, idx):
    super().__init__(env)
    spec = env.observation_spec()
    if not isinstance(spec, array_spec.ArraySpec) or len(spec.shape) != 1:
      raise ValueError("requires a single 1-D observation spec")
    self._idx = np.asarray(idx)
    self._observation_spec = spec.replace(shape=(len(self._idx),))

  def observation_spec(self):
    return self._observation_spec

  def _filter(self, time_step):
    return time_step.replace(
        observation=np.asarray(time_step.observation)[self._idx])

  def _reset(self):
    return self._filter(self._env.reset())

  def _step(self, action):
    return self._filter(self._env.step(action))


class FlattenActionWrapper(PyEnvironmentBaseWrapper):
  """A nest of continuous action specs as one 1-D action, laid out in the
  JAX package's leaf order (dict keys sorted)."""

  def __init__(self, env):
    super().__init__(env)
    self._nest_spec = env.action_spec()
    self._leaves = nest_utils.flatten_sorted(self._nest_spec,
                                             is_leaf=array_spec._is_spec)
    if not all(array_spec.is_continuous(s) for s in self._leaves):
      raise ValueError("FlattenActionWrapper requires continuous specs")
    self._sizes = [int(np.prod(s.shape)) if s.shape else 1
                   for s in self._leaves]
    lows = np.concatenate([np.broadcast_to(s.minimum, s.shape or (1,)).ravel()
                           for s in self._leaves])
    highs = np.concatenate([np.broadcast_to(s.maximum, s.shape or (1,)).ravel()
                            for s in self._leaves])
    self._action_spec = array_spec.BoundedArraySpec(
        (sum(self._sizes),), self._leaves[0].dtype, lows, highs, "action")

  def action_spec(self):
    return self._action_spec

  def _step(self, action):
    flat = np.asarray(action)
    parts, off = [], 0
    for s, size in zip(self._leaves, self._sizes):
      parts.append(flat[off:off + size].reshape(s.shape).astype(s.dtype))
      off += size
    return self._env.step(nest_utils.unflatten_sorted(
        self._nest_spec, parts, is_leaf=array_spec._is_spec))


class ExtraDisabledActionsWrapper(PyEnvironmentBaseWrapper):
  """Adds `num_extra_actions` unusable actions, and a validity mask to
  the observation: ``{"observation": obs, "valid_actions": mask}``."""

  def __init__(self, env, num_extra_actions: int):
    super().__init__(env)
    spec = env.action_spec()
    if not array_spec.is_discrete(spec) or spec.shape != ():
      raise ValueError("Requires scalar discrete action spec")
    self._orig_num = spec.num_values
    self._total = self._orig_num + num_extra_actions
    self._action_spec = array_spec.BoundedArraySpec(
        (), spec.dtype, 0, self._total - 1, "action")
    self._observation_spec = {
        "observation": env.observation_spec(),
        "valid_actions": array_spec.BoundedArraySpec(
            (self._total,), np.bool_, False, True, "valid_actions"),
    }

  def observation_spec(self):
    return self._observation_spec

  def action_spec(self):
    return self._action_spec

  def _mask(self, time_step):
    mask = np.zeros((self._total,), np.bool_)
    mask[:self._orig_num] = True
    return time_step.replace(observation={
        "observation": time_step.observation, "valid_actions": mask})

  def _reset(self):
    return self._mask(self._env.reset())

  def _step(self, action):
    a = int(np.asarray(action))
    if a >= self._orig_num:
      raise ValueError(f"Disabled action {a} taken (valid < {self._orig_num})")
    return self._mask(self._env.step(action))


class GoalReplayEnvWrapper(PyEnvironmentBaseWrapper):
  """Hindsight goal relabelling hooks: a goal-conditioned env subclasses
  this and implements `get_goal_from_trajectory` and
  `get_trajectory_with_goal`."""

  def get_goal_from_trajectory(self, trajectory):
    raise NotImplementedError

  def get_trajectory_with_goal(self, trajectory, goal):
    raise NotImplementedError
