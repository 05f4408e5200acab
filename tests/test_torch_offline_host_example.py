"""`examples/cql_sac_offline_host_torch.py`, the twin of the host pipeline of
``examples/cql_sac_offline.py``, on the CPU against the JAX package.

Held piece by piece, since the asynchronous behaviour run cannot repeat
across packages (its collector and trainer race):
  - a dataset written by the JAX `TrajectoryFileObserver` loads into the
    port's offline ring with the same count and rows;
  - phase C's train calls, from the JAX agent's params carried across by
    `convert` and with the JAX run's draws replayed (the samples'
    `replay_t0` / `replay_rows`, every CQL draw), equal JAX's scanned
    `train_chunk` (rtol 1e-5 / atol 1e-5: `test_torch_cql_agent.py` says
    why CQL's rounding reaches 1e-5);
  - phase B's `collect` with a deterministic numpy policy on seeded
    gymnasium `Pendulum-v1` writes the same shards, byte for byte, as the
    JAX example's `PyDriver` + `TrajectoryFileObserver` (:231-240);
  - the mixed dataset's frame split and snapshot steps are the JAX
    example's, its phases A and B run over the same scripted loop
    (:198-217, :244-245);
  - `reuse_phase_ab` reads a JAX-written ``offline.jsonl``;
and both mixes run end to end at `--smoke` size on `Pendulum-v1`,
returning `_phase_c`'s keys.
"""
import ast
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from agents_tpu.drivers.py_driver import PyDriver as JaxPyDriver
from agents_tpu.environments import suite_gym as jsuite_gym
from agents_tpu.environments.batched_py_environment import \
    BatchedPyEnvironment as JaxBatchedPyEnvironment
from agents_tpu.metrics import py_metrics as jpy_metrics
from agents_tpu.replay_buffers import UniformReplay as JaxUniformReplay
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import policy_step as jps
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu.utils import dataset_io as jdataset_io
from agents_tpu_torch.environments import suite_gym
from agents_tpu_torch.environments.batched_py_environment import \
    BatchedPyEnvironment
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import convert, dataset_io
from agents_tpu_torch.utils.draws import ReplayDraws
from examples import cql_sac_offline as jex
from examples import cql_sac_offline_host_torch as ex
from test_torch_cql_agent import assert_cql_states_close, jax_cql_train_draws
from test_torch_parity_utils import (assert_close, jax_sample_draws,
                                     merge_draws)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = ATOL = 1e-5
B, T = 4, 24
FIELDS = ("step_type", "observation", "action", "next_step_type", "reward",
          "discount")


def _specs(spec_lib):
  return (spec_lib.ArraySpec((3,), np.float32, "observation"),
          spec_lib.BoundedArraySpec((1,), np.float32, -2.0, 2.0, "action"))


def _jax_dataset(path, frames=T, seed=0):
  """`frames` random [B, ...] frames written by the JAX observer in shards
  of 10; returns (its data spec, the frames [T, B, ...] by field)."""
  obs, act = _specs(jspec)
  data_spec = jtj.trajectory_spec(jts.time_step_spec(obs), act)
  rng = np.random.RandomState(seed)
  rows = {
      "step_type": rng.choice([0, 1, 2], (frames, B)).astype(np.int32),
      "observation": rng.randn(frames, B, 3).astype(np.float32),
      "action": rng.uniform(-2, 2, (frames, B, 1)).astype(np.float32),
      "next_step_type": rng.choice([0, 1, 2], (frames, B)).astype(np.int32),
      "reward": rng.randn(frames, B).astype(np.float32),
      "discount": rng.choice([0.0, 1.0], (frames, B)).astype(np.float32)}
  observer = jdataset_io.TrajectoryFileObserver(str(path), data_spec,
                                                frames_per_shard=10)
  for t in range(frames):
    observer(jtj.Trajectory(policy_info=(), **{k: v[t]
                                               for k, v in rows.items()}))
  observer.flush()
  return data_spec, rows


def _port_data_spec():
  obs, act = _specs(tspec)
  return ttj.trajectory_spec(tts.time_step_spec(obs), act)


def test_jax_dataset_loads_into_the_port_ring(tmp_path):
  """The ring is sized from the dataset on disk and holds its frames in
  order, as the JAX `dataset_to_replay` fills its own."""
  jspec_, rows = _jax_dataset(tmp_path)
  cfg = ex.Config(env_batch_size=B, device="cpu")
  replay, rstate = ex.load_offline_replay(cfg, _port_data_spec(),
                                          str(tmp_path), "cpu")
  jreplay = JaxUniformReplay(jspec_, B, jdataset_io.dataset_num_frames(
      str(tmp_path)))
  template = jax.tree_util.tree_map(
      lambda s: np.zeros((1,) + tuple(s.shape), s.dtype), jspec_)
  jstate = jdataset_io.dataset_to_replay(str(tmp_path), template, jreplay,
                                         jreplay.init())
  assert replay.capacity == jreplay.capacity == T
  assert rstate.count == int(jstate.count) == T
  jstorage = jax.device_get(jstate.storage)
  for name in FIELDS:
    np.testing.assert_array_equal(getattr(rstate.storage, name).numpy(),
                                  getattr(jstorage, name), name)
    np.testing.assert_array_equal(getattr(rstate.storage, name).numpy(),
                                  rows[name], name)


def _narrow_config(**overrides):
  return dataclasses.replace(
      ex.Config(env_batch_size=B, actor_fc_layers=(16, 16),
                critic_joint_fc_layers=(16, 16, 16), offline_batch_size=8,
                num_cql_samples=3, num_bc_steps=3, train_steps_per_call=2,
                device="cpu"), **overrides)


def test_phase_c_train_chunks_match_jax(tmp_path):
  """Three train calls of 2 steps (crossing the BC steps) over the same
  dataset: the JAX example's `_make_sac` agent and scanned `train_chunk`
  with ``key(seed + 3)``'s chain, and the port's from the JAX initial
  state with those keys' draws replayed; losses and the whole state after
  each call."""
  jspec_, _ = _jax_dataset(tmp_path)
  cfg = _narrow_config()
  jcfg = jex.Config(**{k: v for k, v in dataclasses.asdict(cfg).items()
                       if k != "device"})
  obs, act = _specs(jspec)
  jtss = jts.time_step_spec(obs)
  jagent = jex._make_sac(jcfg, jtss, act, cql=True)
  jreplay = JaxUniformReplay(jspec_, B, T)
  template = jax.tree_util.tree_map(
      lambda s: np.zeros((1,) + tuple(s.shape), s.dtype), jspec_)
  jrstate = jdataset_io.dataset_to_replay(str(tmp_path), template, jreplay,
                                          jreplay.init())

  def jax_train_chunk(ag, key):       # `_phase_c`'s (:329-338)
    def one(a, k):
      exp, _ = jreplay.sample(jrstate, k, cfg.offline_batch_size,
                              num_steps=jagent.train_sequence_length)
      a, loss = jagent.train(a, exp)
      return a, loss.loss
    ag, losses = jax.lax.scan(one, ag, jax.random.split(
        key, cfg.train_steps_per_call))
    return ag, losses[-1]

  jtrain_chunk = jax.jit(jax_train_chunk)
  jstate = jagent.init(jax.random.key(cfg.seed + 2))
  key = jax.random.key(cfg.seed + 3)
  calls, records = [], []
  for call in range(3):
    key, k = jax.random.split(key)
    calls.append(k)
    for j, kk in enumerate(jax.random.split(k, cfg.train_steps_per_call)):
      records.append(jax_sample_draws(kk, cfg.offline_batch_size, T - 1, B))
      records.append(jax_cql_train_draws(
          call * cfg.train_steps_per_call + j, cfg.num_cql_samples,
          sample_batch_size=cfg.offline_batch_size))
  draws = ReplayDraws(merge_draws(*records))

  tss, tact = tts.time_step_spec(_specs(tspec)[0]), _specs(tspec)[1]
  tagent = ex.make_sac(cfg, tss, tact, cql=True, device="cpu", seed=0)
  replay, rstate = ex.load_offline_replay(cfg, _port_data_spec(),
                                          str(tmp_path), "cpu")
  tstate = convert.load_cql_sac_agent_state(
      tagent.init(draws=draws),
      convert.cql_sac_agent_state_to_torch(jax.device_get(jstate)))
  assert_cql_states_close(jstate, tstate, "initial")
  for i, k in enumerate(calls):
    jstate, jloss = jtrain_chunk(jstate, k)
    tstate, tloss = ex.train_chunk(cfg, tagent, tstate, replay, rstate,
                                   draws)
    assert_close(tloss, jloss, RTOL, ATOL, f"call {i} loss")
    assert_cql_states_close(jstate, tstate, f"call {i}")
  assert tstate.train_step == 3 * cfg.train_steps_per_call
  assert all(v == 0 for v in draws.remaining().values())


class _LinearPolicy:
  """A deterministic numpy policy both packages' `PyDriver`s can call:
  ``clip(obs @ w, -2, 2)``."""

  def __init__(self, policy_step):
    self._w = np.array([[0.7], [-0.4], [0.2]], np.float32)
    self._policy_step = policy_step

  def action(self, time_step, policy_state=()):
    a = np.clip(np.asarray(time_step.observation) @ self._w, -2.0, 2.0)
    return self._policy_step(action=a.astype(np.float32), state=policy_state)


def test_collect_writes_the_jax_shards(tmp_path):
  """Two collects into one observer (random play would be the first in
  "mixed"): the port's `collect` and the JAX example's lines on seeded
  `Pendulum-v1` rows give the same shards, the same driver steps and
  returns; `max_steps` counts non-boundary frames summed over the rows,
  so each collect stops past its frames by less than a row's count."""
  from agents_tpu_torch.trajectories import policy_step as tps

  frames = (250, 620)        # Pendulum ends its episodes at 200 steps
  jenv = JaxBatchedPyEnvironment([jsuite_gym.load("Pendulum-v1")
                                  for _ in range(B)])
  tenv = BatchedPyEnvironment([suite_gym.load("Pendulum-v1")
                               for _ in range(B)])
  jenv.seed(5)
  tenv.seed(5)
  jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
  jobs = jdataset_io.TrajectoryFileObserver(
      jdir, jtj.trajectory_spec(jenv.time_step_spec(), jenv.action_spec()),
      frames_per_shard=64)
  tobs = dataset_io.TrajectoryFileObserver(
      tdir, ttj.trajectory_spec(tenv.time_step_spec(), tenv.action_spec()),
      frames_per_shard=64)
  for n in frames:
    m, ticks = jpy_metrics.AverageReturnMetric(100), []
    JaxPyDriver(jenv, _LinearPolicy(jps.PolicyStep),
                observers=[jobs, m, ticks.append],
                max_steps=n).run(jenv.reset())
    ret, port_ticks = ex.collect(tenv, _LinearPolicy(tps.PolicyStep), tobs,
                                 n)
    assert port_ticks == len(ticks)
    assert ret == pytest.approx(float(m.result()), rel=1e-6, abs=1e-6)
    boundaries = sum(int(np.sum(t.step_type == 2)) for t in ticks)
    assert n <= port_ticks * B - boundaries < n + B
  jobs.flush()
  tobs.flush()
  jshards, tshards = sorted(os.listdir(jdir)), sorted(os.listdir(tdir))
  assert jshards == tshards and len(jshards) > 2
  assert dataset_io.dataset_num_frames(tdir) == \
      jdataset_io.dataset_num_frames(jdir)
  for name in jshards:
    if name.endswith(".npz"):
      with np.load(os.path.join(jdir, name)) as j, \
          np.load(os.path.join(tdir, name)) as t:
        assert sorted(j.files) == sorted(t.files)
        for leaf in j.files:
          assert j[leaf].dtype == t[leaf].dtype, (name, leaf)
          np.testing.assert_array_equal(t[leaf], j[leaf], f"{name} {leaf}")
    else:
      with open(os.path.join(jdir, name)) as j, \
          open(os.path.join(tdir, name)) as t:
        assert json.load(t) == json.load(j)


def _scripted_run(init):
  """An async loop `run` that trains and collects nothing: it counts
  ``total_env_batch_steps`` ticks of ``env.batch_size`` env steps and calls
  `progress_fn` every `progress_every` ticks, as the loop does, over the
  agent state `init(loop, seed)`."""
  def run(self, total_env_batch_steps, seed=0, initial_random_steps=100,
          progress_fn=None, progress_every=1000, **unused):
    del initial_random_steps, unused
    init(self, seed)
    for tick in range(total_env_batch_steps):
      self._env_steps = (tick + 1) * self.env.batch_size
      if progress_fn and (tick + 1) % progress_every == 0:
        progress_fn(self)
    return {"agent_state": self._agent_state, "env_steps": self._env_steps,
            "train_steps": 0, "metrics": {}}
  return run


def jax_phase_ab_schedule(jcfg, monkeypatch):
  """The JAX example's phases A and B on `Pendulum-v1` with its loop's
  `run` scripted (`_scripted_run`), its `PyDriver` recording `max_steps`
  and collecting nothing, its evals and `_phase_c` stubbed: (the env steps
  at which it takes each snapshot, the frames each collect asks for)."""
  from agents_tpu.agents.sac import SacAgent as JaxSacAgent
  from agents_tpu.drivers import py_driver as jpy_driver
  from agents_tpu.eval import metric_utils as jmetric_utils
  from agents_tpu.train import AsyncHostDeviceTrainLoop as JaxLoop

  snapped, frames, loop = [], [], {}

  def init(self, seed):
    loop["it"] = self
    self._agent_state = self.agent.init(jax.random.key(seed))

  collect_policy_params = JaxSacAgent.collect_policy_params

  def recording(agent, agent_state):
    # Each call is a snapshot: at a progress call, or after the run.
    snapped.append(loop["it"]._env_steps)
    return collect_policy_params(agent, agent_state)

  class Driver:
    def __init__(self, env, policy, observers=(), max_steps=None, **unused):
      frames.append(max_steps)

    def run(self, time_step):
      return time_step, None

  monkeypatch.setattr(JaxLoop, "run", _scripted_run(init))
  monkeypatch.setattr(JaxSacAgent, "collect_policy_params", recording)
  monkeypatch.setattr(jpy_driver, "PyDriver", Driver)
  monkeypatch.setattr(jmetric_utils, "compute",
                      lambda *a, **k: {"AverageReturn": 0.0})
  monkeypatch.setattr(jex, "_phase_c", lambda *a, **k: {})
  jex.train_eval(dataclasses.replace(jcfg, env_name="Pendulum-v1"))
  return snapped, frames


def port_phase_ab_schedule(cfg, monkeypatch):
  """The port's phases A and B stubbed as `jax_phase_ab_schedule` stubs
  the JAX example's (its `collect` records the frames asked): (the env
  steps of its snapshots, the frames each collect asks for)."""
  from agents_tpu_torch.eval import metric_utils
  from agents_tpu_torch.train import AsyncHostDeviceTrainLoop

  frames, stats = [], {}

  def init(self, seed):
    self.template_state(seed)
    self._collect_params = self._live_params()

  def collect(env, policy, observer, n):
    frames.append(n)
    return 0.0, 0

  monkeypatch.setattr(AsyncHostDeviceTrainLoop, "run", _scripted_run(init))
  monkeypatch.setattr(ex, "collect", collect)
  monkeypatch.setattr(metric_utils, "compute",
                      lambda *a, **k: {"AverageReturn": 0.0})
  monkeypatch.setattr(ex, "phase_c", lambda *a, **k: {})
  ex.train_eval(dataclasses.replace(cfg, env_name="Pendulum-v1"),
                stats=stats)
  return stats["phase_a"]["snapshot_env_steps"], frames


@pytest.mark.parametrize("fields", [
    dict(),
    dict(behavior_env_steps=1600, env_batch_size=4, dataset_frames=800),
    dict(behavior_env_steps=16_384, dataset_frames=32_768),
    dict(snapshot_fractions=(0.5, 1.0), mixed_random_fraction=0.3,
         dataset_frames=1001)])
def test_mixed_split_and_snapshot_steps_follow_jax(fields, tmp_path,
                                                   monkeypatch):
  """Both examples' phases A and B over the same scripted loop: the port
  snapshots at the env steps the JAX example's progress function does
  (:198-217) and splits the dataset's frames as its collects do
  (:244-245)."""
  root = dict(root_dir=str(tmp_path / "jax"))
  jcfg = dataclasses.replace(jex.Config(dataset_mix="mixed"), **fields,
                             **root)
  cfg = dataclasses.replace(ex.Config(dataset_mix="mixed", device="cpu"),
                            **fields, root_dir=str(tmp_path / "port"))
  jax_snapped, jax_frames = jax_phase_ab_schedule(jcfg, monkeypatch)
  assert len(jax_snapped) == len(jcfg.snapshot_fractions)
  assert port_phase_ab_schedule(cfg, monkeypatch) == (jax_snapped,
                                                      jax_frames)
  assert ex.snapshot_env_steps(dataclasses.replace(cfg,
                                                   dataset_mix="medium")) == []


def test_mixed_run_snapshots_where_jax_would(tmp_path, monkeypatch):
  """The port's run at `--smoke` size takes its snapshots at the env steps
  the JAX example's phase A would over the same ticks, and collects the
  frames its phase B asks for."""
  cfg = dataclasses.replace(ex.Config(**ex.SMOKE), dataset_mix="mixed",
                            root_dir=str(tmp_path / "port"), device="cpu",
                            offline_train_steps=16)
  stats = {}
  ex.train_eval(cfg, stats=stats)
  jcfg = dataclasses.replace(jex.Config(**ex.SMOKE), dataset_mix="mixed",
                             root_dir=str(tmp_path / "jax"),
                             offline_train_steps=16)
  jax_snapped, jax_frames = jax_phase_ab_schedule(jcfg, monkeypatch)
  assert stats["phase_a"]["snapshot_env_steps"] == jax_snapped
  assert [c["frames"] for c in stats["phase_b"]["collects"]] == jax_frames
  assert sum(c["ticks"] for c in stats["phase_b"]["collects"]) == \
      dataset_io.dataset_num_frames(os.path.join(cfg.root_dir, "dataset")) \
      == stats["phase_c"]["ring_count"]


def test_reuse_reads_a_jax_offline_jsonl(tmp_path):
  """The comparators of a JAX run's ``offline.jsonl`` (written by its
  `JsonlSummaryWriter`), the last value of each; a medium run's best is
  its behaviour return."""
  from agents_tpu.train import JsonlSummaryWriter as JaxJsonlSummaryWriter

  for name, values, expect in (
      ("mixed", [("behavior_return", -300.0),
                 ("behavior_best_return", -120.5),
                 ("dataset_policy_return", -150.25)],
       (-300.0, -120.5, -150.25)),
      ("medium", [("behavior_return", -410.0),
                  ("dataset_policy_return", -380.0),
                  ("offline_eval_return", -200.0)],
       (-410.0, -410.0, -380.0))):
    src = tmp_path / name
    writer = JaxJsonlSummaryWriter(str(src / "offline.jsonl"))
    for key, value in values:
      writer.scalar(key, value, 0)
    writer.close()
    assert ex.read_comparators(str(src)) == pytest.approx(expect)
  empty = tmp_path / "empty"
  writer = JaxJsonlSummaryWriter(str(empty / "offline.jsonl"))
  writer.scalar("behavior_return", -1.0, 0)
  writer.close()
  with pytest.raises(ValueError, match="comparators"):
    ex.read_comparators(str(empty))


def _jax_phase_c_keys():
  """The keys of the dict `_phase_c` returns, read from its source."""
  tree = ast.parse(open(os.path.join(ROOT, "examples",
                                     "cql_sac_offline.py")).read())
  fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name == "_phase_c")
  (ret,) = [n for n in ast.walk(fn) if isinstance(n, ast.Return)
            and isinstance(n.value, ast.Dict)]
  return sorted(k.value for k in ret.value.keys)


@pytest.mark.parametrize("mix", ["medium", "mixed"])
def test_smoke_runs_end_to_end_and_reuses(tmp_path, mix):
  """`train_eval` at `--smoke` on `Pendulum-v1`; then phase C again
  through `reuse_phase_ab`, which repeats the first run's losses and final
  parameters exactly (the same dataset, seeds and draws)."""
  from agents_tpu_torch.policies.policy_saver import load_policy

  cfg = dataclasses.replace(ex.Config(**ex.SMOKE), dataset_mix=mix,
                            root_dir=str(tmp_path / "first"), device="cpu")
  out = ex.train_eval(cfg)
  assert sorted(out) == _jax_phase_c_keys()
  again = ex.train_eval(dataclasses.replace(
      cfg, root_dir=str(tmp_path / "reuse"), reuse_phase_ab=cfg.root_dir))
  assert sorted(again) == _jax_phase_c_keys()
  for key in ("behavior_return", "behavior_best_return",
              "dataset_policy_return"):
    assert again[key] == out[key]

  def losses(root):
    with open(os.path.join(root, "offline.jsonl")) as f:
      return [r["cql_loss"] for r in map(json.loads, f) if "cql_loss" in r]

  assert losses(cfg.root_dir) == losses(str(tmp_path / "reuse"))
  assert len(losses(cfg.root_dir)) == 2
  saved = [torch.load(os.path.join(root, "policies", "greedy_policy",
                                   "params.pt"), weights_only=True)
           for root in (cfg.root_dir, str(tmp_path / "reuse"))]
  assert all(torch.equal(saved[0][k], saved[1][k]) for k in saved[0])
  policy = load_policy(os.path.join(cfg.root_dir, "policies",
                                    "greedy_policy"), device="cpu")
  step = tts.TimeStep(step_type=np.zeros(3, np.int32),
                      reward=np.zeros(3, np.float32),
                      discount=np.ones(3, np.float32),
                      observation=np.random.RandomState(0).randn(
                          3, 3).astype(np.float32))
  action = np.asarray(policy.action(step).action)
  assert action.shape == (3, 1) and np.all(np.abs(action) <= 2.0)
