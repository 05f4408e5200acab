"""The port's native ingest ring (`replay_buffers/host_ingest.py`) and its
build (`utils/native_build.py`), against the JAX package's.

The ring is the JAX package's C++ source, built by the port into its own
ignored directory. A frame encodes to the same bytes in both packages
(the JAX leaf order: dict keys sorted, dataclass fields in order), so a
JAX `IngestClient` can feed a port `IngestServer` and back. Ring and
store names carry the process id and a random suffix, since the JAX
package's tests create segments beside these ones.
"""
import hashlib
import multiprocessing as mp
import os
import secrets
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from agents_tpu import specs as jspecs
from agents_tpu.replay_buffers import host_ingest as jax_host_ingest
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch import specs
from agents_tpu_torch.replay_buffers import UniformReplay
from agents_tpu_torch.replay_buffers.host_ingest import (FrameCodec,
                                                         IngestClient,
                                                         IngestServer)
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import native_build
from agents_tpu_torch.utils.draws import Draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = {
    "obs": specs.ArraySpec((4,), np.float32),
    "action": specs.ArraySpec((), np.int32),
    "reward": specs.ArraySpec((), np.float32),
}


def _name(tag):
  return f"t_ingest_{tag}_{os.getpid()}_{secrets.token_hex(4)}"


def _frames(n, start=0):
  return {"obs": np.random.RandomState(start).randn(n, 4).astype(np.float32),
          "action": np.arange(start, start + n, dtype=np.int32),
          "reward": np.linspace(0, 1, n).astype(np.float32)}


def _pair_specs(lib, ts_lib, tj_lib):
  """A [2, ...] trajectory-pair spec with a dict observation whose keys
  are out of order, in either package."""
  obs = {"velocity": lib.ArraySpec((3,), np.float32),
         "angle": lib.ArraySpec((), np.float64),
         "pixels": lib.ArraySpec((2, 2), np.uint8)}
  action = lib.BoundedArraySpec((2,), np.float32, -2.0, 2.0)
  tss = ts_lib.time_step_spec(obs)
  add_outer_dims = getattr(lib, "add_outer_dims_nest", None) or \
      lib.array_spec.add_outer_dims_nest
  return add_outer_dims(tj_lib.trajectory_spec(tss, action), (2,))


def _pair_frames(rng, n, tj_lib, convert):
  obs = {"velocity": rng.randn(n, 2, 3).astype(np.float32),
         "angle": rng.randn(n, 2),
         "pixels": rng.randint(0, 255, (n, 2, 2, 2)).astype(np.uint8)}
  return tj_lib.Trajectory(
      step_type=convert(rng.randint(0, 3, (n, 2)).astype(np.int32)),
      observation={k: convert(v) for k, v in obs.items()},
      action=convert(rng.uniform(-2, 2, (n, 2, 2)).astype(np.float32)),
      policy_info=(),
      next_step_type=convert(rng.randint(0, 3, (n, 2)).astype(np.int32)),
      reward=convert(rng.randn(n, 2).astype(np.float32)),
      discount=convert(np.ones((n, 2), np.float32)))


def test_build_goes_to_the_ports_own_directory():
  for name in ("ingest", "varstore"):
    path = native_build.build_library(name)
    assert os.path.dirname(path) == native_build.BUILD_DIR
    assert not path.startswith(os.path.join(ROOT, "native"))
    assert os.path.getmtime(path) >= os.path.getmtime(
        os.path.join(ROOT, "native", name, f"{name}.cc"))


def _native_build_snapshot():
  out = {}
  build = os.path.join(ROOT, "native", "build")
  for f in sorted(os.listdir(build)):
    path = os.path.join(build, f)
    with open(path, "rb") as fh:
      out[f] = (os.stat(path).st_mtime_ns, hashlib.sha256(fh.read()).hexdigest())
  return out


def test_two_concurrent_builds_give_one_loadable_library(tmp_path):
  """Two processes build the same library into a fresh directory at once:
  the lock and the rename leave one whole library and no temporary file,
  both get its path, it loads; `native/build/` keeps its mtimes and
  bytes. (The JAX package's own rebuild, which may run make on a fresh
  checkout, is settled first.)"""
  jax_host_ingest.ensure_built()
  before = _native_build_snapshot()
  code = ("import sys; sys.path.insert(0, {root!r})\n"
          "from agents_tpu_torch.utils import native_build\n"
          "native_build.BUILD_DIR = {d!r}\n"
          "print(native_build.build_library('ingest'))\n").format(
              root=ROOT, d=str(tmp_path))
  procs = [subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True) for _ in range(2)]
  outs = [p.communicate(timeout=240) for p in procs]
  assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
  paths = {o.strip() for o, _ in outs}
  assert paths == {str(tmp_path / "libagents_tpu_ingest.so")}
  assert sorted(os.listdir(tmp_path)) == ["ingest.lock",
                                          "libagents_tpu_ingest.so"]
  import ctypes
  lib = ctypes.CDLL(paths.pop())
  assert hasattr(lib, "ingest_create") and hasattr(lib, "ingest_drain")
  assert _native_build_snapshot() == before


def test_failed_build_raises_without_falling_back(tmp_path, monkeypatch):
  """A source that does not compile raises; nothing is loaded instead."""
  native = tmp_path / "native"
  (native / "broken").mkdir(parents=True)
  (native / "broken" / "broken.cc").write_text("this is not C++\n")
  monkeypatch.setattr(native_build, "NATIVE_DIR", str(native))
  monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "build"))
  with pytest.raises(RuntimeError, match="failed"):
    native_build.build_library("broken")
  assert not (tmp_path / "build" / "libagents_tpu_broken.so").exists()


def test_codec_roundtrip():
  codec = FrameCodec(SPEC)
  frames = _frames(5)
  buf = codec.encode_batch(frames)
  assert buf.shape == (5, codec.frame_bytes)
  out = codec.decode_batch(buf)
  for k in frames:
    np.testing.assert_array_equal(out[k], frames[k])


def test_codec_bytes_equal_the_jax_codecs():
  """A trajectory pair with a dict observation (keys out of order) and a
  float64 leaf encodes to the same bytes in both packages, and decodes
  back to the port's Trajectory."""
  port_spec = _pair_specs(specs, tts, ttj)
  jax_spec = _pair_specs(jspecs, jts, jtj)
  tcodec, jcodec = FrameCodec(port_spec), jax_host_ingest.FrameCodec(jax_spec)
  assert tcodec.frame_bytes == jcodec.frame_bytes
  assert tcodec.offsets == jcodec.offsets
  rng = np.random.RandomState(0)
  tframes = _pair_frames(rng, 7, ttj, np.asarray)
  jframes = _pair_frames(np.random.RandomState(0), 7, jtj, np.asarray)
  tbytes = tcodec.encode_batch(tframes)
  np.testing.assert_array_equal(tbytes, jcodec.encode_batch(jframes))
  # CPU tensors encode alike.
  tensor_frames = _pair_frames(np.random.RandomState(0), 7, ttj,
                               torch.from_numpy)
  np.testing.assert_array_equal(tcodec.encode_batch(tensor_frames), tbytes)
  out = tcodec.decode_batch(tbytes)
  assert isinstance(out, ttj.Trajectory)
  assert list(out.observation) == ["velocity", "angle", "pixels"]
  for k in out.observation:
    np.testing.assert_array_equal(out.observation[k], tframes.observation[k])
  np.testing.assert_array_equal(out.action, tframes.action)


def test_push_drain_same_process():
  name = _name("a")
  server = IngestServer(name, SPEC, capacity=64)
  client = IngestClient(name, SPEC)
  try:
    frames = {"obs": np.ones((3, 4), np.float32),
              "action": np.asarray([1, 2, 3], np.int32),
              "reward": np.asarray([0.5, 1.5, 2.5], np.float32)}
    assert client.push(frames) == 3
    assert server.size() == 3
    out = server.drain()
    np.testing.assert_array_equal(out["action"], [1, 2, 3])
    assert server.size() == 0
    assert server.drain() is None
  finally:
    client.close()
    server.close()


def test_backpressure_drops():
  name = _name("b")
  server = IngestServer(name, SPEC, capacity=4)
  client = IngestClient(name, SPEC)
  try:
    assert client.push(_frames(6)) == 4
    assert server.dropped() == 2
  finally:
    client.close()
    server.close()


def test_spec_mismatch_and_bad_capacity_refused():
  name = _name("m")
  server = IngestServer(name, SPEC, capacity=8)
  try:
    with pytest.raises(ValueError, match="frame_bytes"):
      IngestClient(name, {"obs": specs.ArraySpec((5,), np.float32)})
  finally:
    server.close()
  with pytest.raises(RuntimeError):
    IngestServer(_name("c"), SPEC, capacity=6)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_rings_cross_packages(direction):
  """A JAX client pushes into a port server's ring, and a port client into
  a JAX server's: the drains give equal frames."""
  port_spec = _pair_specs(specs, tts, ttj)
  jax_spec = _pair_specs(jspecs, jts, jtj)
  name = _name("x")
  if direction == "jax_to_port":
    server = IngestServer(name, port_spec, capacity=16)
    client = jax_host_ingest.IngestClient(name, jax_spec)
    frames = _pair_frames(np.random.RandomState(1), 5, jtj, np.asarray)
  else:
    server = jax_host_ingest.IngestServer(name, jax_spec, capacity=16)
    client = IngestClient(name, port_spec)
    frames = _pair_frames(np.random.RandomState(1), 5, ttj, np.asarray)
  expect = _pair_frames(np.random.RandomState(1), 5, ttj, np.asarray)
  try:
    assert client.push(frames) == 5
    out = server.drain()
    for k in expect.observation:
      np.testing.assert_array_equal(np.asarray(out.observation[k]),
                                    expect.observation[k])
    for f in ("step_type", "action", "next_step_type", "reward", "discount"):
      np.testing.assert_array_equal(np.asarray(getattr(out, f)),
                                    getattr(expect, f), err_msg=f)
  finally:
    client.close()
    server.close()


def _producer(name, pid, n):
  client = IngestClient(name, SPEC)
  sent = 0
  while sent < n:
    b = min(8, n - sent)
    pushed = client.push({
        "obs": np.full((b, 4), pid, np.float32),
        "action": np.arange(sent, sent + b, dtype=np.int32),
        "reward": np.full(b, pid, np.float32)})
    sent += pushed
    if pushed < b:
      time.sleep(0.001)
  client.close()


def test_multiprocess_producers_integrity():
  """Two producer processes (spawned) push 500 frames each through a
  256-slot ring: each producer's frames arrive complete and in order."""
  n_per = 500
  name = _name("p")
  server = IngestServer(name, SPEC, capacity=256)
  ctx = mp.get_context("spawn")
  procs = [ctx.Process(target=_producer, args=(name, pid, n_per))
           for pid in (1, 2)]
  try:
    for p in procs:
      p.start()
    got, total = {1: [], 2: []}, 0
    deadline = time.time() + 60
    while total < 2 * n_per and time.time() < deadline:
      out = server.drain(max_frames=128)
      if out is None:
        time.sleep(0.001)
        continue
      pids = out["reward"].astype(np.int32)
      for pid in (1, 2):
        got[pid].extend(out["action"][pids == pid].tolist())
      assert (out["obs"] == out["reward"][:, None]).all()
      total += len(pids)
    for p in procs:
      p.join(10)
    assert total == 2 * n_per
    for pid in (1, 2):
      assert got[pid] == list(range(n_per))
  finally:
    for p in procs:
      if p.is_alive():
        p.kill()
        p.join()
    server.close()


def test_ingest_feeds_device_replay():
  name = _name("d")
  server = IngestServer(name, SPEC, capacity=64)
  client = IngestClient(name, SPEC)
  try:
    client.push({"obs": np.random.randn(4, 4).astype(np.float32),
                 "action": np.asarray([0, 1, 2, 3], np.int32),
                 "reward": np.asarray([1., 2., 3., 4.], np.float32)})
    out = server.drain()
    replay = UniformReplay(SPEC, batch_size=4, max_length=8, device="cpu")
    state = replay.add_batch(replay.init(), {k: torch.from_numpy(v)
                                             for k, v in out.items()})
    assert state.count == 1
    batch, _ = replay.sample(state, Draws(0, "cpu"), 16)
    assert set(batch["action"].tolist()).issubset({0, 1, 2, 3})
    assert_rewards = batch["reward"] == batch["action"].float() + 1
    assert bool(assert_rewards.all())
  finally:
    client.close()
    server.close()
