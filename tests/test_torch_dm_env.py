"""The dm_env adapters, the suites, golden-trajectory tooling and the
batched-observer adapter of `agents_tpu_torch`, held against the JAX
package's modules (``tests/test_dm_env_adapter.py``,
``tests/test_dm_control_real.py``, ``tests/test_interop_adapters.py``).

Host environments are numpy on both sides, so every comparison is exact:
specs (shape, dtype, bounds, names), step types, rewards, discounts and
observations. The real dm_control backend runs here on the CPU; its
pixel variant renders in a child process (EGL in the suite's process
breaks later C-extension imports, as the JAX test notes).
"""
import collections
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from agents_tpu.environments import dm_env_wrapper as jax_dm
from agents_tpu.environments import suites as jax_suites
from agents_tpu.environments import trajectory_replay as jax_replay
from agents_tpu.environments.test_envs import CountingPyEnv as JaxCounting
from agents_tpu.trajectories import policy_step as jps
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu.utils.observers import \
    BatchedObserverUnbatching as JaxUnbatching
from agents_tpu_torch.environments import suite_dm_control, suites
from agents_tpu_torch.environments import utils as env_utils
from agents_tpu_torch.environments import wrappers
from agents_tpu_torch.environments.batched_py_environment import \
    BatchedPyEnvironment
from agents_tpu_torch.environments.dm_env_wrapper import (DmEnvWrapper,
                                                          PyToDmWrapper,
                                                          convert_spec,
                                                          convert_time_step)
from agents_tpu_torch.environments.test_envs import CountingPyEnv
from agents_tpu_torch.environments.trajectory_replay import (
    TrajectoryReplay, record_policy_actions)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils.observers import BatchedObserverUnbatching

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DmTimeStep = collections.namedtuple(
    "DmTimeStep", ["step_type", "reward", "discount", "observation"])


class FakeArraySpec:

  def __init__(self, shape, dtype, name=None):
    self.shape, self.dtype, self.name = shape, dtype, name


class FakeBoundedSpec(FakeArraySpec):

  def __init__(self, shape, dtype, minimum, maximum, name=None):
    super().__init__(shape, dtype, name)
    self.minimum, self.maximum = minimum, maximum


class FakeDmEnv:
  """The dm_env.Environment protocol: float64 dict observations, bounded
  float64 actions, reward=None on restart (the JAX test's fake)."""

  def __init__(self, episode_len=3):
    self.episode_len = episode_len
    self._t = 0
    self.closed = False

  def observation_spec(self):
    return collections.OrderedDict(
        position=FakeArraySpec((2,), np.float64, "position"),
        velocity=FakeArraySpec((3,), np.float64, "velocity"))

  def action_spec(self):
    return FakeBoundedSpec((2,), np.float64, -1.0, 1.0, "action")

  def _obs(self):
    return collections.OrderedDict(
        position=np.full((2,), float(self._t), np.float64),
        velocity=np.zeros((3,), np.float64))

  def reset(self):
    self._t = 0
    return DmTimeStep(0, None, None, self._obs())

  def step(self, action):
    assert action.dtype == np.float64, "adapter must cast to the dm spec"
    self._t += 1
    if self._t >= self.episode_len:
      return DmTimeStep(2, 1.0, 0.0, self._obs())
    return DmTimeStep(1, 0.5, 1.0, self._obs())

  def close(self):
    self.closed = True


def _leaves(nest):
  if isinstance(nest, dict):
    return [x for k in nest for x in _leaves(nest[k])]
  return [nest]


def assert_same_spec(a, b):
  assert type(a).__name__ == type(b).__name__
  assert tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype
  assert a.name == b.name
  if hasattr(b, "minimum"):
    np.testing.assert_array_equal(a.minimum, b.minimum)
    np.testing.assert_array_equal(a.maximum, b.maximum)


def assert_same_time_step(a, b):
  for f in ("step_type", "reward", "discount"):
    x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
    assert x.dtype == y.dtype, f
    np.testing.assert_array_equal(x, y, err_msg=f)
  if isinstance(b.observation, dict):
    assert list(a.observation) == list(b.observation)
  for x, y in zip(_leaves(a.observation), _leaves(b.observation)):
    assert np.asarray(x).dtype == np.asarray(y).dtype
    np.testing.assert_array_equal(x, y)


# -- inbound adapter ---------------------------------------------------------

@pytest.mark.parametrize("spec", [
    FakeArraySpec((2,), np.float64, "p"),
    FakeBoundedSpec((1,), np.float64, -2.0, 3.0, "b"),
    FakeArraySpec((), np.int32),
    FakeBoundedSpec((3,), np.int64, 0, 4)])
def test_convert_spec_matches_jax(spec):
  ours, theirs = convert_spec(spec), jax_dm.convert_spec(spec)
  assert_same_spec(ours, theirs)
  if spec.dtype == np.float64:
    assert ours.dtype == np.float32


def test_convert_time_step_matches_jax():
  for dm_ts in (DmTimeStep(0, None, None, np.zeros(2, np.float64)),
                DmTimeStep(1, 0.5, 1.0, np.ones(2, np.float64)),
                DmTimeStep(2, 1.0, 0.0, {"a": np.ones(3, np.int32)})):
    assert_same_time_step(convert_time_step(dm_ts),
                          jax_dm.convert_time_step(dm_ts))
  first = convert_time_step(DmTimeStep(0, None, None, np.zeros(2)))
  assert int(first.step_type) == ts.StepType.FIRST
  assert float(first.reward) == 0.0 and float(first.discount) == 1.0


def test_dm_env_wrapper_episode_matches_jax():
  ours = DmEnvWrapper(FakeDmEnv(episode_len=2))
  theirs = jax_dm.DmEnvWrapper(FakeDmEnv(episode_len=2))
  assert list(ours.observation_spec()) == ["position", "velocity"]
  for k in ("position", "velocity"):
    assert_same_spec(ours.observation_spec()[k],
                     theirs.observation_spec()[k])
  assert_same_spec(ours.action_spec(), theirs.action_spec())
  assert_same_time_step(ours.reset(), theirs.reset())
  steps = []
  for _ in range(4):  # MID, LAST, then the auto-reset's FIRST and a MID
    a = ours.step(np.zeros((2,), np.float32))
    assert_same_time_step(a, theirs.step(np.zeros((2,), np.float32)))
    steps.append(int(a.step_type))
  assert steps == [1, 2, 0, 1]
  ours.close()
  assert ours._env.closed
  assert ours.physics is None
  with pytest.raises(ValueError):
    ours.render("human")


def test_dm_env_wrapper_passes_validate():
  env_utils.validate_py_environment(DmEnvWrapper(FakeDmEnv()), episodes=2)


def test_wrap_dm_env_flatten_and_extra_wrappers():
  env = suites.wrap_dm_env(FakeDmEnv(), flatten_observations=True)
  jenv = jax_suites.wrap_dm_env(FakeDmEnv(), flatten_observations=True)
  assert_same_time_step(env.reset(), jenv.reset())
  assert env.reset().observation.shape == (5,)
  env2 = suites.wrap_dm_env(
      FakeDmEnv(), env_wrappers=(lambda e: wrappers.TimeLimit(e, 2),))
  env2.reset()
  env2.step(np.zeros((2,), np.float32))
  assert env2.step(np.zeros((2,), np.float32)).is_last()


def test_suite_loaders_gate_on_backend():
  assert suites.is_dm_control_available() == \
      jax_suites.is_dm_control_available()
  for name in ("atari", "pybullet", "bsuite"):
    available = getattr(suites, f"is_{name}_available")()
    assert available == getattr(jax_suites, f"is_{name}_available")()
    if not available:
      loader = getattr(suites, f"load_{name}")
      with pytest.raises(ImportError, match=f"suite_{name}"):
        loader("PongNoFrameskip-v4" if name != "bsuite" else "deep_sea/0")
  assert suite_dm_control.is_available is suites.is_dm_control_available


# -- outbound adapter and observers ------------------------------------------

def test_py_to_dm_wrapper_matches_jax():
  ours = PyToDmWrapper(CountingPyEnv(steps_per_episode=3))
  theirs = jax_dm.PyToDmWrapper(JaxCounting(steps_per_episode=3))
  import dm_env
  for a, b in zip([ours.reset()] + [ours.step(0) for _ in range(4)],
                  [theirs.reset()] + [theirs.step(0) for _ in range(4)]):
    assert isinstance(a, dm_env.TimeStep)
    assert a.step_type == b.step_type
    for x, y in zip(a[1:], b[1:]):
      np.testing.assert_array_equal(x, y)
  first = ours.reset()
  assert first.first() and first.reward == 0.0 and first.discount == 1.0
  steps = [ours.step(0) for _ in range(3)]
  assert steps[-1].last() and all(s.mid() for s in steps[:-1])
  import dm_env.specs as dm_specs
  for fn in ("observation_spec", "action_spec", "reward_spec",
             "discount_spec"):
    a, b = getattr(ours, fn)(), getattr(theirs, fn)()
    assert isinstance(a, (dm_specs.Array, dm_specs.BoundedArray))
    assert type(a) is type(b) and a.shape == b.shape and a.dtype == b.dtype


def test_py_to_dm_wrapper_rejects_batched_env():
  batched = BatchedPyEnvironment(
      [CountingPyEnv(steps_per_episode=3) for _ in range(2)])
  with pytest.raises(ValueError, match="unbatched"):
    PyToDmWrapper(batched)


def _frame(module, make):
  return module.Trajectory(
      step_type=make(np.zeros((3,), np.int32)),
      observation=make(np.arange(6.0, dtype=np.float32).reshape(3, 2)),
      action=make(np.arange(3, dtype=np.int32)), policy_info=(),
      next_step_type=make(np.ones((3,), np.int32)),
      reward=make(np.asarray([1.0, 2.0, 3.0], np.float32)),
      discount=make(np.ones((3,), np.float32)))


@pytest.mark.parametrize("make", [np.asarray, torch.as_tensor])
def test_batched_observer_unbatching_matches_jax(make):
  def collect(cls, frame):
    seen = []

    def make_observer():
      rows = []
      seen.append(rows)
      return rows.append

    obs = cls(make_observer, batch_size=3)
    obs(frame)
    obs(frame)
    assert len(obs.delegated_observers) == 3
    return seen

  ours = collect(BatchedObserverUnbatching, _frame(tj, make))
  theirs = collect(JaxUnbatching, _frame(jtj, np.asarray))
  assert len(ours) == len(theirs) == 3
  for rows_a, rows_b in zip(ours, theirs):
    assert len(rows_a) == len(rows_b) == 2
    for f in ("step_type", "observation", "action", "reward", "discount"):
      np.testing.assert_array_equal(np.asarray(getattr(rows_a[0], f)),
                                    np.asarray(getattr(rows_b[0], f)))
  with pytest.raises(ValueError):
    BatchedObserverUnbatching(list, batch_size=0)


# -- golden trajectories -------------------------------------------------------

def _assert_same_frames(ours, theirs):
  assert len(ours) == len(theirs)
  for a, b in zip(ours, theirs):
    for f in ("step_type", "observation", "action", "next_step_type",
              "reward", "discount"):
      np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                    np.asarray(getattr(b, f)), err_msg=f)


def test_trajectory_replay_matches_jax():
  actions = [0, 1, 1, 0, 1, 0, 0]
  _assert_same_frames(
      TrajectoryReplay(CountingPyEnv(steps_per_episode=3)).run(actions),
      jax_replay.TrajectoryReplay(JaxCounting(steps_per_episode=3)).run(
          actions))


class _CyclePolicy:
  """A host policy of the `JittedPyPolicy` surface: action t is t % 2, the
  state counts the calls; steps are `policy_step`'s `PolicyStep`s."""

  def __init__(self, policy_step):
    self.policy_step = policy_step

  def init_state(self, batch_size):
    return 0

  def action(self, time_step, state):
    return self.policy_step.PolicyStep(
        action=np.asarray(state % 2, np.int32), state=state + 1)


def test_record_policy_actions_replays_to_the_same_frames():
  actions, frames = record_policy_actions(
      CountingPyEnv(steps_per_episode=2), _CyclePolicy(ps), 5)
  jactions, jframes = jax_replay.record_policy_actions(
      JaxCounting(steps_per_episode=2), _CyclePolicy(jps), 5)
  np.testing.assert_array_equal(actions, jactions)
  _assert_same_frames(frames, jframes)
  _assert_same_frames(
      TrajectoryReplay(CountingPyEnv(steps_per_episode=2)).run(actions),
      frames)


# -- the real dm_control backend ------------------------------------------------

def test_dm_control_load_matches_jax_step_for_step():
  pytest.importorskip("dm_control")
  kwargs = dict(task_kwargs={"random": 3})
  ours = suite_dm_control.load("cartpole", "swingup", **kwargs)
  theirs = jax_suites.load_dm_control("cartpole", "swingup", **kwargs)
  ospec = ours.observation_spec()
  assert isinstance(ospec, dict) and set(ospec) == {"position", "velocity"}
  for k in ospec:
    assert ospec[k].dtype == np.float32
    assert_same_spec(ospec[k], theirs.observation_spec()[k])
  aspec = ours.action_spec()
  assert isinstance(aspec, array_spec.BoundedArraySpec)
  assert aspec.minimum == -1.0 and aspec.maximum == 1.0
  assert_same_time_step(ours.reset(), theirs.reset())
  rng = np.random.RandomState(0)
  total = 0.0
  for _ in range(30):
    a = rng.uniform(-1, 1, size=(1,)).astype(np.float32)
    step = ours.step(a)
    assert_same_time_step(step, theirs.step(a))
    total += float(step.reward)
  assert int(step.step_type) == int(ts.StepType.MID)
  assert total > 0.0
  env_utils.validate_py_environment(
      suite_dm_control.load("cartpole", "balance"), episodes=1)


def test_dm_control_load_pixels_in_a_child():
  pytest.importorskip("dm_control")
  child = """
import os
os.environ["MUJOCO_GL"] = "egl"
import sys
import numpy as np
from agents_tpu_torch.environments import suite_dm_control
env = suite_dm_control.load_pixels(
    "cartpole", "balance", render_kwargs={"width": 32, "height": 32})
px = env.reset().observation["pixels"]
assert px.shape == (32, 32, 3) and px.dtype == np.uint8, (px.shape, px.dtype)
spec = env.observation_spec()["pixels"]
assert tuple(spec.shape) == (32, 32, 3) and spec.dtype == np.uint8
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "agents_tpu")]
print("PIXELS_OK")
"""
  out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                       text=True, timeout=300, cwd=REPO)
  assert "PIXELS_OK" in out.stdout, (out.stdout[-500:], out.stderr[-1500:])


def test_dm_control_transitions_train_ddpg_like_jax():
  """`tests/test_dm_control_real.py`'s DDPG smoke, held against the JAX
  agent: the port's host pipeline (two flattened real cartpole-balance
  envs, `JittedPyPolicy`, `PyDriver`, `PyUniformReplayBuffer`) collects
  96 steps; one DDPG step of each package from the same converted
  weights on the same sampled batch gives the same losses and networks
  (rtol 1e-5 / atol 1e-6)."""
  pytest.importorskip("dm_control")
  import jax
  import jax.numpy as jnp
  import optax

  from agents_tpu import networks as jnetworks
  from agents_tpu.agents.ddpg import DdpgAgent as JaxDdpgAgent
  from agents_tpu_torch.agents.ddpg import DdpgAgent
  from agents_tpu_torch.drivers.py_driver import PyDriver
  from agents_tpu_torch.networks import (make_critic_network,
                                         make_deterministic_actor_network)
  from agents_tpu_torch.policies.jitted_py_policy import JittedPyPolicy
  from agents_tpu_torch.replay_buffers.py_uniform_replay import \
      PyUniformReplayBuffer
  from agents_tpu_torch.utils import convert, nest_utils

  env = BatchedPyEnvironment([wrappers.FlattenObservationsWrapper(
      suite_dm_control.load("cartpole", "balance")) for _ in range(2)])
  jenv = _jax_specs(env)
  tss, asp = env.time_step_spec(), env.action_spec()
  jagent = JaxDdpgAgent(
      *jenv, jnetworks.make_deterministic_actor_network(
          jenv[0].observation, jenv[1], fc_layer_params=(32,)),
      jnetworks.make_critic_network(jenv[0].observation, jenv[1],
                                    joint_fc_layer_params=(32,)),
      optax.adam(1e-3), optax.adam(1e-3))
  agent = DdpgAgent(
      tss, asp, make_deterministic_actor_network(tss.observation, asp, (32,),
                                                 device="cpu"),
      make_critic_network(tss.observation, asp, joint_fc_layer_params=(32,),
                          device="cpu"),
      lambda p: torch.optim.Adam(p, lr=1e-3),
      lambda p: torch.optim.Adam(p, lr=1e-3), device="cpu")
  jstate = jagent.init(jax.random.key(0))
  state = convert.load_ddpg_agent_state(
      agent.init(), convert.ddpg_agent_state_to_torch(jax.device_get(jstate)))

  buf = PyUniformReplayBuffer(tj.trajectory_spec(tss, asp), 512,
                              writer_batch_size=2)
  policy = JittedPyPolicy(agent.collect_policy,
                          agent.collect_policy_params(state), seed=0,
                          device="cpu")
  PyDriver(env, policy, observers=[buf.add_batch], max_steps=96).run(
      env.reset(), policy_state=policy.init_state(2))
  batch = buf.sample(32, num_steps=2, rng=np.random.RandomState(0))
  assert np.asarray(batch.observation).shape == (32, 2, 5)

  jstate2, jinfo = jax.jit(jagent.train)(
      jstate, jax.tree_util.tree_map(jnp.asarray, jtj.Trajectory(
          **{f: getattr(batch, f) for f in (
              "step_type", "observation", "action", "next_step_type",
              "reward", "discount")}, policy_info=())))
  state2, info = agent.train(state, nest_utils.tree_map(torch.as_tensor,
                                                        batch))
  np.testing.assert_allclose(float(info.loss), float(jinfo.loss),
                             rtol=1e-5, atol=1e-6)
  assert np.isfinite(float(info.loss))
  expect = convert.ddpg_agent_state_to_torch(jax.device_get(jstate2))
  for field in ("actor_network", "critic_network"):
    for k, v in getattr(state2, field).state_dict().items():
      np.testing.assert_allclose(v.numpy(), np.asarray(expect[field][k]),
                                 rtol=1e-5, atol=1e-6, err_msg=k)


def _jax_specs(env):
  """The JAX package's time-step and action specs of `env`'s specs."""
  from agents_tpu.specs import array_spec as jspec
  from agents_tpu.trajectories import time_step as jts
  obs, act = env.observation_spec(), env.action_spec()
  jobs = jspec.ArraySpec(obs.shape, obs.dtype)
  jact = jspec.BoundedArraySpec(act.shape, act.dtype, act.minimum,
                                act.maximum)
  return jts.time_step_spec(jobs), jact
