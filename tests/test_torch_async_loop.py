"""`AsyncHostDeviceTrainLoop` of the PyTorch port: a collector thread (the
caller's) and a trainer thread over state that is updated in place.

  - The invariants of ``tests/test_async_loop.py``: `run` is re-entrant
    (fresh counters, a live trainer), env steps are exact, the trainer
    never passes the UTD budget by more than one call.
  - Checkpoint and resume as in ``tests/test_checkpoint_resume.py:100-160``
    (periodic and final checkpoints, a fresh loop resumed toward a higher
    target continues the counters and metrics; the restored state equals
    the saved one tensor for tensor), and the JAX loop's checkpoint dict
    carried into the port by `convert` and resumed from.
  - The snapshot: a stub agent's train call writes its call number into
    every parameter one layer at a time with a pause between layers; every
    collector tick sees a single call number. The same run with the
    collector acting from the live parameters (a literal transcription of
    the JAX loop, which relied on immutable arrays) sees mixed ones.
  - Torn windows: an env whose observation encodes (row, step index);
    every sampled window holds consecutive steps of one row. A trainer
    that samples the replay state it took at the start of its call, as
    the JAX trainer does, reads windows whose oldest frame a concurrent
    insert overwrote.

Every run joins its trainer with a timeout, and each test asserts the
trainer is gone.
"""
import dataclasses
import sys
import time

import jax
import numpy as np
import optax
import pytest
import torch
from torch import nn

from agents_tpu import networks as jnetworks
from agents_tpu.agents.sac import SacAgent as JaxSacAgent
from agents_tpu.environments import suite_gym as jsuite_gym
from agents_tpu.environments.batched_py_environment import \
    BatchedPyEnvironment as JaxBatchedPyEnvironment
from agents_tpu.metrics import py_metrics as jpy_metrics
from agents_tpu.replay_buffers import UniformReplay as JaxUniformReplay
from agents_tpu.train import AsyncHostDeviceTrainLoop as JaxAsyncLoop
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch.agents.sac import SacAgent
from agents_tpu_torch.environments import suite_gym
from agents_tpu_torch.environments.batched_py_environment import \
    BatchedPyEnvironment
from agents_tpu_torch.environments.py_environment import (PyEnvironment,
                                                          np_restart,
                                                          np_termination,
                                                          np_transition)
from agents_tpu_torch.environments.test_envs import CountingPyEnv
from agents_tpu_torch.metrics import py_metrics
from agents_tpu_torch.networks import (make_critic_network,
                                       make_sac_actor_network)
from agents_tpu_torch.replay_buffers import UniformReplay
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.train import AsyncHostDeviceTrainLoop, Checkpointer
from agents_tpu_torch.train.checkpointer import capture
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import convert, nest_utils
from agents_tpu_torch.utils.common import LossInfo

torch.set_num_threads(1)

B, K = 2, 4


def _sac_loop(metrics=True, cls=AsyncHostDeviceTrainLoop):
  env = BatchedPyEnvironment([suite_gym.load("Pendulum-v1")
                              for _ in range(B)])
  env.seed(0)
  tss, asp = env.time_step_spec(), env.action_spec()
  g = torch.Generator().manual_seed(0)
  adam = lambda p: torch.optim.Adam(p, lr=3e-4)  # noqa: E731
  agent = SacAgent(
      tss, asp,
      make_critic_network(tss.observation, asp, joint_fc_layer_params=(16,),
                          device="cpu", generator=g),
      make_sac_actor_network(tss.observation, asp, fc_layer_params=(16,),
                             device="cpu", generator=g),
      adam, adam, adam, device="cpu")
  replay = UniformReplay(tj.trajectory_spec(tss, asp), B, 256, device="cpu")
  return cls(env, agent, replay, sample_batch_size=16,
             train_steps_per_call=K, utd_ratio=1.0, min_replay_frames=4 * B,
             py_metrics=([py_metrics.AverageReturnMetric(5),
                          py_metrics.EnvironmentSteps()] if metrics else ()),
             device="cpu")


def _paced(seconds):
  """A progress function that holds each collector tick `seconds`, as a
  slower simulator would, so that the trainer keeps up on the CPU."""
  return dict(progress_fn=lambda loop: time.sleep(seconds), progress_every=1)


def _assert_drained(loop, out):
  assert out["trainer_drained"]
  assert not loop._trainer_thread.is_alive()


def test_async_loop_trains_and_is_reentrant():
  loop = _sac_loop()
  out1 = loop.run(total_env_batch_steps=60, seed=0, initial_random_steps=4,
                  **_paced(0.005))
  _assert_drained(loop, out1)
  assert out1["env_steps"] == 120
  assert out1["train_steps"] > 0, "the trainer never trained (run 1)"
  out2 = loop.run(total_env_batch_steps=60, seed=1, initial_random_steps=4,
                  **_paced(0.005))
  _assert_drained(loop, out2)
  assert out2["env_steps"] == 120
  assert out2["train_steps"] > 0, "the trainer is dead on the second run"
  # Per-run counters, and the UTD budget of 1.0 passed by one call at most.
  for out in (out1, out2):
    assert out["train_steps"] % K == 0
    assert out["train_steps"] <= 1.0 * out["env_steps"] + K
    assert np.isfinite(out["last_loss"])
    assert out["metrics"]["EnvironmentSteps"] == out["env_steps"]
    assert out["ticks_trainer_idle"] + out["ticks_trainer_busy"] == 60


def test_each_run_starts_from_the_built_networks():
  loop = _sac_loop(metrics=False)
  before = {k: v.clone() for k, v in loop.agent.actor_network.state_dict(
  ).items()}
  out = loop.run(total_env_batch_steps=40, seed=0, initial_random_steps=2,
                 **_paced(0.005))
  assert out["train_steps"] > 0
  assert any(not torch.equal(before[k], v) for k, v in
             out["agent_state"].actor_network.state_dict().items())
  loop.template_state()
  for k, v in loop.agent.actor_network.state_dict().items():
    assert torch.equal(before[k], v), k


def test_async_loop_checkpoint_resume(tmp_path):
  ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
  loop = _sac_loop()
  out1 = loop.run(total_env_batch_steps=60, seed=0, initial_random_steps=4,
                  checkpointer=ckpt, checkpoint_interval_ticks=25,
                  **_paced(0.005))
  _assert_drained(loop, out1)
  assert out1["env_steps"] == 120
  # Periodic saves at 25 and 50, the final state at 60; two kept.
  assert ckpt.all_steps() == [50, 60]
  saved = torch.load(str(tmp_path / "ck" / "60.pt"), weights_only=True)
  assert saved["state"]["counters"] == {"tick": 60,
                                        "train_steps": out1["train_steps"]}
  saved_actor = {k: v.clone() for k, v in
                 out1["agent_state"].actor_network.state_dict().items()}

  loop2 = _sac_loop()
  out2 = loop2.run(total_env_batch_steps=90, seed=0, initial_random_steps=4,
                   checkpointer=ckpt, checkpoint_interval_ticks=25,
                   resume=True, **_paced(0.005))
  _assert_drained(loop2, out2)
  assert out2["env_steps"] == 180            # continued, not restarted
  assert out2["train_steps"] > out1["train_steps"]
  assert out2["train_steps"] <= out2["env_steps"] + K
  resumed = out2["agent_state"].actor_network.state_dict()
  assert any(not torch.equal(saved_actor[k], resumed[k]) for k in resumed)
  env_steps_metric = [m for m in loop2.py_metrics
                      if m.name == "EnvironmentSteps"][0]
  assert env_steps_metric.result() == 180    # both sessions' frames
  assert ckpt.latest_step() == 90


def _mismatches(a, b, path="state"):
  if isinstance(a, torch.Tensor):
    return [] if a.dtype == b.dtype and torch.equal(a, b) else [path]
  if isinstance(a, dict):
    if list(a) != list(b):
      return [path]
    return [p for k in a for p in _mismatches(a[k], b[k], f"{path}.{k}")]
  if isinstance(a, (list, tuple)):
    return [p for i, (x, y) in enumerate(zip(a, b, strict=True))
            for p in _mismatches(x, y, f"{path}[{i}]")]
  return [] if a == b else [path]


def test_async_resume_exact_state_roundtrip(tmp_path):
  """The restored state equals the loop's end-of-run state tensor for
  tensor: agent, optimizers, replay, the three draw sources, counters and
  metric states."""
  ckpt = Checkpointer(str(tmp_path / "ck"))
  loop = _sac_loop()
  loop.run(total_env_batch_steps=30, seed=0, initial_random_steps=4,
           checkpointer=ckpt, checkpoint_interval_ticks=30, **_paced(0.005))
  assert ckpt.latest_step() == 30
  live = capture(loop._checkpoint_state(30))
  assert live["agent_state"]["train_step"] > 0
  loop2 = _sac_loop()
  restored = capture(ckpt.restore(loop2.template_state(seed=5)))
  assert _mismatches(live, restored) == []
  assert restored["metrics"][1] == {"count": 60}


def test_jax_checkpoint_dict_resumes_in_the_port(tmp_path):
  """The JAX async loop's checkpoint dict (agent, replay, counters, metric
  states) carried across by `convert`, saved by the port's
  `Checkpointer` and resumed by the port's loop toward a higher target."""
  jenv = JaxBatchedPyEnvironment([jsuite_gym.load("Pendulum-v1")
                                  for _ in range(B)])
  tss, asp = jenv.time_step_spec(), jenv.action_spec()
  jagent = JaxSacAgent(
      tss, asp,
      critic_network=jnetworks.make_critic_network(
          tss.observation, asp, joint_fc_layer_params=(16,)),
      actor_network=jnetworks.make_sac_actor_network(
          tss.observation, asp, fc_layer_params=(16,)),
      actor_optimizer=optax.adam(3e-4), critic_optimizer=optax.adam(3e-4),
      alpha_optimizer=optax.adam(3e-4))
  jloop = JaxAsyncLoop(
      jenv, jagent, JaxUniformReplay(jtj.trajectory_spec(tss, asp), B, 256),
      sample_batch_size=16, train_steps_per_call=K, utd_ratio=1.0,
      min_replay_frames=4 * B,
      py_metrics=[jpy_metrics.AverageReturnMetric(5),
                  jpy_metrics.EnvironmentSteps()])
  jloop.run(total_env_batch_steps=30, seed=0, initial_random_steps=4)
  jsaved = jax.device_get(jloop._checkpoint_state(30, jax.random.key(0)))

  loop = _sac_loop()
  state = loop.template_state()
  agent_state = convert.load_sac_agent_state(
      state["agent_state"],
      convert.sac_agent_state_to_torch(jsaved["agent_state"]))
  replay_state = convert.load_uniform_replay_state(
      state["replay_state"],
      convert.uniform_replay_state_to_torch(jsaved["replay_state"]))
  for m, st in zip(loop.py_metrics,
                   convert.py_metric_states_to_torch(jsaved["metrics"])):
    m.set_state(st)
  assert replay_state.count == 29
  state = dict(state, agent_state=agent_state, replay_state=replay_state,
               counters={"tick": 30, "train_steps": int(
                   jsaved["counters"]["train_steps"])},
               metrics=py_metrics.fixed_shape_states(loop.py_metrics))
  ckpt = Checkpointer(str(tmp_path / "ck"))
  ckpt.save(30, state)

  loop2 = _sac_loop()
  out = loop2.run(total_env_batch_steps=45, seed=0, initial_random_steps=4,
                  checkpointer=ckpt, checkpoint_interval_ticks=100,
                  resume=True, **_paced(0.005))
  _assert_drained(loop2, out)
  assert out["env_steps"] == 90
  assert out["train_steps"] >= int(jsaved["counters"]["train_steps"])
  jres = {m.name: m.result() for m in jloop.py_metrics}
  assert out["metrics"]["EnvironmentSteps"] == jres["EnvironmentSteps"] + 30
  assert ckpt.latest_step() == 45


# -- stubs for the snapshot and torn-window tests ------------------------------

@dataclasses.dataclass(frozen=True)
class StubState:
  net: nn.Module
  calls: int
  train_step: int


class StubNet(nn.Module):
  def __init__(self, layers):
    super().__init__()
    self.layers = nn.ParameterList(
        [nn.Parameter(torch.zeros(3)) for _ in range(layers)])


class StubPolicy:
  """Records the call numbers it reads from each layer; acts 0."""

  def __init__(self):
    self.seen = []

  def action(self, params, time_step, state=(), draws=None):
    self.seen.append(tuple(float(p[0]) for p in params.layers))
    b = time_step.step_type.shape[0]
    return ps.PolicyStep(action=torch.zeros(b, dtype=torch.int32))


class StubAgent:
  """A train call writes its call number into each layer in turn, with a
  pause between layers; it records the observations of every sample."""

  def __init__(self, action_spec, layers=4, pause=0.001,
               train_sequence_length=2):
    self.device = torch.device("cpu")
    self.action_spec = action_spec
    self.collect_policy = StubPolicy()
    self.train_sequence_length = train_sequence_length
    self.net = StubNet(layers)
    self.pause = pause
    self.samples = []

  def init(self):
    return StubState(net=self.net, calls=0, train_step=0)

  def collect_policy_params(self, state):
    return state.net

  policy_params = collect_policy_params

  def train(self, state, experience):
    self.samples.append(experience.observation.clone())
    with torch.no_grad():
      for p in state.net.layers:
        p.fill_(state.train_step + 1)
        time.sleep(self.pause)
    return (dataclasses.replace(state, train_step=state.train_step + 1),
            LossInfo(loss=torch.tensor(0.0)))


class RowStepEnv(PyEnvironment):
  """Observation (row, step index); the index counts every step of the
  row, resets included; episodes of 5 steps."""

  def __init__(self, row):
    super().__init__()
    self._row, self._t, self._n = row, 0, 0

  def observation_spec(self):
    return tspec.ArraySpec((2,), np.float32)

  def action_spec(self):
    return tspec.BoundedArraySpec((), np.int32, 0, 1)

  def _obs(self):
    self._t += 1
    return np.asarray([self._row, self._t], np.float32)

  def _reset(self):
    self._n = 0
    return np_restart(self._obs())

  def _step(self, action):
    self._n += 1
    if self._n >= 5:
      return np_termination(self._obs(), np.asarray(1.0, np.float32))
    return np_transition(self._obs(), np.asarray(1.0, np.float32))


class LiteralSnapshotLoop(AsyncHostDeviceTrainLoop):
  """Acts from the live parameters, with no snapshot."""

  def _acting_params(self):
    return self._live_params()

  def _publish(self):
    pass


class LiteralReplayLoop(AsyncHostDeviceTrainLoop):
  """Samples the replay state taken at the start of each train call,
  without the lock."""

  def _train_call(self):
    replay_state, agent_state = self._replay_state, self._agent_state
    for _ in range(self.train_steps_per_call):
      experience, _ = self.replay.sample(
          replay_state, self._trainer_draws, self.sample_batch_size,
          num_steps=self.agent.train_sequence_length)
      agent_state, info = self.agent.train(agent_state, experience)
    self._agent_state = agent_state
    return info.loss


def _stub_run(cls, env, agent, capacity, ticks, sample_batch_size=8):
  tss = env.time_step_spec()
  replay = UniformReplay(tj.trajectory_spec(tss, env.action_spec()),
                         env.batch_size, capacity, device="cpu")
  loop = cls(env, agent, replay, sample_batch_size=sample_batch_size,
             train_steps_per_call=K, min_replay_frames=capacity *
             env.batch_size, device="cpu")
  # A short switch interval interleaves the two threads more finely.
  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-5)
  try:
    out = loop.run(total_env_batch_steps=ticks, seed=0,
                   initial_random_steps=0, **_paced(0.0002))
  finally:
    sys.setswitchinterval(interval)
  _assert_drained(loop, out)
  return out


def _mixed_ticks(seen):
  return sum(len(set(values)) > 1 for values in seen)


@pytest.mark.parametrize("cls,expect_mixed",
                         [(AsyncHostDeviceTrainLoop, False),
                          (LiteralSnapshotLoop, True)],
                         ids=["snapshot", "literal"])
def test_collector_acts_from_one_whole_train_call(cls, expect_mixed):
  env = BatchedPyEnvironment([CountingPyEnv(4) for _ in range(B)])
  agent = StubAgent(env.action_spec())
  out = _stub_run(cls, env, agent, capacity=16, ticks=400)
  seen = agent.collect_policy.seen
  assert len(seen) == 400
  assert out["train_steps"] >= 2 * K, "too few train calls to test"
  # Calls completed while the collector ran: the snapshot moved on.
  assert max(max(v) for v in seen) >= K
  mixed = _mixed_ticks(seen)
  if expect_mixed:
    assert mixed > 0, "the literal transcription showed no torn read"
  else:
    assert mixed == 0, f"{mixed} ticks acted from two train calls"
    # Each snapshot is a whole call's: its number is a multiple of K.
    assert all(v[0] % K == 0 for v in seen)


def _torn_windows(samples):
  torn = 0
  for obs in samples:                      # [S, n, 2]
    rows, steps = obs[..., 0], obs[..., 1]
    torn += int(((rows != rows[:, :1]).any(dim=1)
                 | (steps[:, 1:] - steps[:, :-1] != 1).any(dim=1)).sum())
  return torn


@pytest.mark.parametrize("cls,expect_torn",
                         [(AsyncHostDeviceTrainLoop, False),
                          (LiteralReplayLoop, True)],
                         ids=["locked", "literal"])
def test_sampled_windows_never_straddle_an_insert(cls, expect_torn):
  env = BatchedPyEnvironment([RowStepEnv(r) for r in range(B)])
  agent = StubAgent(env.action_spec(), layers=1, pause=0.002,
                    train_sequence_length=3)
  _stub_run(cls, env, agent, capacity=8, ticks=400, sample_batch_size=32)
  assert len(agent.samples) >= 4 * K, "too few samples to test"
  torn = _torn_windows(agent.samples)
  if expect_torn:
    assert torn > 0, "the literal transcription tore no window"
  else:
    assert torn == 0, f"{torn} sampled windows mix two sides of an insert"


def test_a_trainer_error_is_raised_from_run():
  env = BatchedPyEnvironment([CountingPyEnv(4) for _ in range(B)])
  agent = StubAgent(env.action_spec())

  def broken(state, experience):
    raise ValueError("train step failed")

  agent.train = broken
  tss = env.time_step_spec()
  replay = UniformReplay(tj.trajectory_spec(tss, env.action_spec()), B, 16,
                         device="cpu")
  loop = AsyncHostDeviceTrainLoop(env, agent, replay, sample_batch_size=4,
                                  train_steps_per_call=K,
                                  min_replay_frames=4, device="cpu")
  with pytest.raises(RuntimeError, match="trainer thread failed"):
    loop.run(total_env_batch_steps=200, initial_random_steps=0,
             **_paced(0.001))
  assert not loop._trainer_thread.is_alive()
