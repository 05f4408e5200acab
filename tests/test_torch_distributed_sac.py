"""Distributed SAC with the port: `examples/sac_train_job_torch.py` and
`examples/sac_collect_job_torch.py`.

The two jobs run their `--smoke` on the CPU with gymnasium Pendulum, as
`tests/test_variable_container.py::test_distributed_job_set_with_shm_weights`
runs the JAX ones: the learner spawns two collect jobs, experience comes
over the ingest rings and weights over the shared-memory store. The
learner's rate limiting is held in process: under `SampleToInsertRatio`
it drains no more than the limiter admits, so the sample-to-insert
difference never leaves its error buffer, and it never samples before
`min_replay_items`.
"""
import json
import os
import secrets
import subprocess
import sys

import numpy as np
import torch

from agents_tpu_torch.environments.test_envs import RandomPyEnvironment
from agents_tpu_torch.replay_buffers.host_ingest import IngestClient
from agents_tpu_torch.replay_buffers.rate_limiter import (MinSize,
                                                          SampleToInsertRatio)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import trajectory as tj
from examples import sac_collect_job_torch, sac_train_job_torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_job_set_runs_its_smoke_on_the_cpu(tmp_path):
  """`--smoke --device cpu`: 200 train steps, items ingested, and both
  collectors stop on the learner's SIGTERM with a last line that shows
  they pulled weight snapshots through shared memory (the same bytes for
  the same step in both).

  The store holds the newest snapshot only, so a collector's first pull
  is whatever the store held at its first successful poll: step 0, unless
  the learner had already pushed again. That happens under load: a
  collector whose start is slow polls first after the other one has fed
  the learner its 64 items and the learner has pushed step 56 (observed:
  the first poll at tick 0 found step 56 after 2 writes)."""
  env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
  proc = subprocess.run(
      [sys.executable, os.path.join(ROOT, "examples",
                                    "sac_train_job_torch.py"),
       "--smoke", "--device", "cpu", f"--root_dir={tmp_path}"],
      env=env, capture_output=True, text=True, timeout=420, cwd=ROOT)
  assert proc.returncode == 0, proc.stderr[-3000:]
  lines = [json.loads(l) for l in proc.stdout.splitlines()
           if l.startswith("{")]
  train = [l for l in lines if l.get("job") == "train" and l.get("done")]
  assert train and train[0]["items_ingested"] > 0
  assert train[0]["train_steps"] >= 200
  assert np.isfinite(train[0]["final_loss"])
  collect = [l for l in lines if l.get("job") == "collect" and l.get("done")]
  assert len(collect) == 2
  crc_by_step = {}
  for c in collect:
    assert c["pushed_items"] > 0
    steps = [s for s, _ in c["pulls"]]
    assert steps == sorted(steps) and steps[-1] > 0, c["pulls"]
    # The first pull is the store's newest snapshot at that poll, and it
    # is step 0 exactly when the learner had pushed only once by then.
    _, (first_step, writes) = c["first_polls"][-1]
    assert first_step == steps[0], (c["pulls"], c["first_polls"])
    assert (steps[0] == 0) == (writes == 1), c["first_polls"]
    for step, crc in c["pulls"]:
      assert crc_by_step.setdefault(step, crc) == crc


# Two children and the parent each write these 64 KB records at once, the
# parent through the job set's `line_logger` and the children through its
# `relay_lines`: every line of the parent's stdout must be one whole record.
RELAY_RECORDS, RELAY_BYTES = 20, 1 << 16
RELAY_PARENT = """
import json, subprocess, sys
sys.path.insert(0, {root!r})
from examples.sac_train_job_torch import line_logger, relay_lines
child = ("import json\\n"
         "for i in range({n}):\\n"
         "  print(json.dumps({{'child': %d, 'i': i, 'pad': 'c' * {size}}}),"
         " flush=True)\\n")
log = line_logger()
procs = [subprocess.Popen([sys.executable, "-c", child % k],
                          stdout=subprocess.PIPE, text=True)
         for k in range(2)]
relays = [relay_lines(p, log) for p in procs]
for i in range({n}):
  log(json.dumps({{"parent": True, "i": i, "pad": "p" * {size}}}))
for p, t in zip(procs, relays):
  p.wait(timeout=60)
  t.join(timeout=60)
"""


def test_job_set_relay_keeps_long_records_whole():
  """C4: the collectors' `done` records exceed a pipe's atomic write, so
  written by two processes into one stdout they could interleave; relayed
  through the learner's one writer, each arrives as a whole line."""
  code = RELAY_PARENT.format(root=ROOT, n=RELAY_RECORDS, size=RELAY_BYTES)
  proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=120)
  assert proc.returncode == 0, proc.stderr[-3000:]
  records = [json.loads(line) for line in proc.stdout.splitlines()]
  assert len(records) == 3 * RELAY_RECORDS
  for who in ({"parent": True}, {"child": 0}, {"child": 1}):
    (key, value), = who.items()
    mine = [r for r in records if r.get(key) == value]
    assert [r["i"] for r in mine] == list(range(RELAY_RECORDS))
    assert all(len(r["pad"]) == RELAY_BYTES for r in mine)


def _specs():
  env = RandomPyEnvironment(
      array_spec.ArraySpec((3,), np.float32),
      array_spec.BoundedArraySpec((1,), np.float32, -2.0, 2.0))
  return env.time_step_spec(), env.action_spec()


def _args(**overrides):
  tag = f"{os.getpid()}_{secrets.token_hex(3)}"
  args = sac_train_job_torch.parse_args([
      f"--rings=t_dsac_{tag}", "--device=cpu", "--ring_capacity=1024",
      "--replay_rows=8", "--replay_max_length=64", "--sample_batch_size=16",
      "--train_steps_per_call=2", "--min_replay_items=24"])
  for k, v in overrides.items():
    setattr(args, k, v)
  return args


def _pairs(tss, asp, rng, n):
  spec = array_spec.add_outer_dims_nest(tj.trajectory_spec(tss, asp), (2,))
  return array_spec.np_sample_spec_nest(spec, rng, (n,))


def test_ratio_learner_stays_in_its_error_buffer():
  """`SampleToInsertRatio` at 2 samples per insert with a backlog of 400
  frames in the ring: every drain keeps ``inserts * spi - samples`` at or
  under ``max_diff``, every train call starts at or over ``min_diff`` plus
  its samples, no call samples before `min_replay_items` frames, and the
  realized ratio approaches 2."""
  tss, asp = _specs()
  args = _args(samples_per_insert=2.0)
  learner = sac_train_job_torch.Learner(args, tss, asp)
  client = IngestClient(args.rings, learner.servers[0].codec.data_spec)
  lim = learner.limiter
  assert isinstance(lim, SampleToInsertRatio)
  diffs, at_sample = [], []
  drain, train_call = learner.drain, learner.train_call

  def diff():
    return lim.inserts * lim.samples_per_insert - lim.samples

  def checked_drain():
    blocks = drain()
    diffs.append(diff())
    return blocks

  def checked_train_call():
    at_sample.append((diff(), lim.inserts))
    train_call()

  learner.drain, learner.train_call = checked_drain, checked_train_call
  try:
    assert client.push(_pairs(tss, asp, np.random.RandomState(0), 400)) == 400
    for _ in range(12):
      learner.step()
    assert learner.train_steps == 24 and len(at_sample) == 12
    assert max(diffs) <= lim.max_diff
    for d, inserts in at_sample:
      assert d - learner.samples_per_chunk >= lim.min_diff
      assert inserts >= args.min_replay_items
    realized = lim.samples / lim.inserts
    assert 1.0 < realized <= 2.0
    assert torch.isfinite(learner.loss)
  finally:
    client.close()
    learner.close()


def test_min_size_learner_waits_for_its_items_then_drains_freely():
  tss, asp = _specs()
  args = _args(min_replay_items=40)
  learner = sac_train_job_torch.Learner(args, tss, asp)
  client = IngestClient(args.rings, learner.servers[0].codec.data_spec)
  try:
    assert isinstance(learner.limiter, MinSize)
    assert sac_train_job_torch.insert_allowance(learner.limiter) > 1 << 40
    client.push(_pairs(tss, asp, np.random.RandomState(1), 30))
    learner.drain()
    learner.flush()
    assert not learner.limiter.can_sample(learner.samples_per_chunk)
    assert learner.replay_state.count == 3 and learner.staged_count == 6
    client.push(_pairs(tss, asp, np.random.RandomState(2), 300))
    learner.step()
    assert learner.total_items == 330 and learner.train_steps == 2
    assert learner.replay_state.count == 41
  finally:
    client.close()
    learner.close()


def test_insert_allowance_and_the_error_buffer_clamp(capsys):
  lim = SampleToInsertRatio(8.0, 512, 4096.0)     # diff bounds [0, 8192]
  assert sac_train_job_torch.insert_allowance(lim) == 1024
  lim.record_insert(1000)
  assert sac_train_job_torch.insert_allowance(lim) == 24
  lim.record_sample(2048)
  assert sac_train_job_torch.insert_allowance(lim) == 24 + 256
  args = _args(samples_per_insert=8.0, sample_insert_error_buffer=10.0)
  limiter, chunk = sac_train_job_torch.make_limiter(args)
  assert chunk == 32 and "clamped" in capsys.readouterr().out
  assert limiter.max_diff - limiter.min_diff == 2 * (0.5 * (32 + 8) + 1)


def test_collector_stops_after_its_ticks_and_reports():
  """`run_collector` with `total_ticks` over random envs (no learner
  weights yet: random actions), into a port ring: every pair it reports
  pushed is in the ring."""
  from agents_tpu_torch.replay_buffers.host_ingest import IngestServer

  tss, asp = _specs()
  args = sac_collect_job_torch.parse_args([
      "--root_dir=unused", f"--ring=t_dsac_c_{os.getpid()}",
      "--env_batch_size=3", "--total_ticks=7"])
  spec = array_spec.add_outer_dims_nest(tj.trajectory_spec(tss, asp), (2,))
  server = IngestServer(args.ring, spec, capacity=64)
  lines = []
  try:
    done = sac_collect_job_torch.run_collector(
        args, make_env=lambda _: RandomPyEnvironment(
            array_spec.ArraySpec((3,), np.float32),
            array_spec.BoundedArraySpec((1,), np.float32, -2.0, 2.0)),
        log=lines.append)
    assert done["ticks"] == 7 and done["pushed_items"] == 6 * 3
    assert done["pulls"] == [] and done["policy_train_step"] == -1
    out = server.drain()
    assert out.step_type.shape == (18, 2)
    # The second frame of a row's pair is the first of its next pair.
    np.testing.assert_array_equal(out.observation[:-3, 1],
                                  out.observation[3:, 0])
  finally:
    server.close()
