"""Port parity: offline datasets on disk (`agents_tpu_torch.utils.
dataset_io`) and `UniformReplay.add_sequence` against the JAX package's.

A dataset written by either side's `TrajectoryFileObserver` streams into
the other side's replay through its `dataset_to_replay`, frame for frame:
the npz layout (``leaf_{i}`` in ``jax.tree_util`` order, dict keys sorted)
and ``spec.json`` are the same bytes of meaning. Frames compare exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu.replay_buffers import UniformReplay as JaxUniformReplay
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu.utils import dataset_io as jdataset_io
from agents_tpu_torch.replay_buffers import UniformReplay
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import dataset_io, nest_utils
from test_torch_parity_utils import assert_equal

B, FRAMES, PER_SHARD = 3, 12, 5


def _data_spec(module, ts_module, tj_module, nested):
  if nested:   # keys out of sorted order: the port keeps insertion order
    obs = {"velocity": module.ArraySpec((2,), np.float32),
           "angle": module.BoundedArraySpec((), np.float32, -3.2, 3.2)}
  else:
    obs = module.BoundedArraySpec((3,), np.float32, -8.0, 8.0)
  act = module.BoundedArraySpec((1,), np.float32, -2.0, 2.0)
  return tj_module.trajectory_spec(ts_module.time_step_spec(obs), act)


def _frames(nested, n=FRAMES, batch=(B,), seed=0):
  """n frames as numpy dicts, each leaf [*batch, ...]."""
  rng = np.random.RandomState(seed)
  out = []
  for _ in range(n):
    obs = ({"velocity": rng.randn(*batch, 2).astype(np.float32),
            "angle": np.asarray(rng.randn(*batch), np.float32)}
           if nested else rng.randn(*batch, 3).astype(np.float32))
    out.append(dict(
        step_type=np.asarray(rng.randint(0, 3, batch), np.int32),
        observation=obs,
        action=rng.uniform(-2, 2, batch + (1,)).astype(np.float32),
        next_step_type=np.asarray(rng.randint(0, 3, batch), np.int32),
        reward=np.asarray(rng.randn(*batch), np.float32),
        discount=np.asarray(rng.choice([0.0, 1.0], batch), np.float32)))
  return out


def _jax_frame(f):
  return jtj.Trajectory(policy_info=(), **f)


def _torch_frame(f):
  return ttj.Trajectory(policy_info=(), **nest_utils.tree_map(
      torch.from_numpy, f))


def _expected(frames, field, row=slice(None)):
  if field == "observation" and isinstance(frames[0][field], dict):
    return {k: np.stack([f[field][k][row] for f in frames])
            for k in frames[0][field]}
  return np.stack([f[field][row] for f in frames])


FIELDS = ("step_type", "observation", "action", "next_step_type", "reward",
          "discount")


def _check_port_ring(rstate, frames):
  """The port ring's frames [T, B, ...] equal `frames` in order."""
  assert rstate.count == len(frames)
  for field in FIELDS:
    got = getattr(rstate.storage, field)
    want = _expected(frames, field)
    if isinstance(want, dict):
      for k in want:
        assert_equal(got[k][:len(frames)], want[k], f"{field}.{k}")
    else:
      assert_equal(got[:len(frames)], want, field)


@pytest.mark.parametrize("nested", [False, True])
def test_jax_shards_load_into_the_port_replay(tmp_path, nested):
  frames = _frames(nested)
  observer = jdataset_io.TrajectoryFileObserver(
      str(tmp_path), _data_spec(jspec, jts, jtj, nested),
      frames_per_shard=PER_SHARD)
  for f in frames:
    observer(_jax_frame(f))
  observer.flush()
  assert sorted(os.listdir(tmp_path)) == [
      "shard_00000.npz", "shard_00001.npz", "shard_00002.npz", "spec.json"]
  assert dataset_io.dataset_num_frames(str(tmp_path)) == FRAMES
  spec = _data_spec(tspec, tts, ttj, nested)
  replay = UniformReplay(spec, B, 16, device="cpu")
  rstate = dataset_io.dataset_to_replay(str(tmp_path), spec, replay,
                                        replay.init())
  _check_port_ring(rstate, frames)
  # spec.json lists the leaves in the same order either side writes them.
  port_dir = tmp_path / "port"
  dataset_io.TrajectoryFileObserver(str(port_dir), spec)
  with open(tmp_path / "spec.json") as a, open(port_dir / "spec.json") as b:
    assert json.load(a) == json.load(b)


@pytest.mark.parametrize("nested", [False, True])
def test_port_shards_load_into_the_jax_replay(tmp_path, nested):
  frames = _frames(nested, seed=1)
  observer = dataset_io.TrajectoryFileObserver(
      str(tmp_path), _data_spec(tspec, tts, ttj, nested),
      frames_per_shard=PER_SHARD)
  for f in frames:
    observer(_torch_frame(f))
  observer.flush()
  assert jdataset_io.dataset_num_frames(str(tmp_path)) == FRAMES
  jspec_nest = _data_spec(jspec, jts, jtj, nested)
  jreplay = JaxUniformReplay(jspec_nest, B, 16)
  template = jax.tree_util.tree_map(
      lambda s: np.zeros((1,) + tuple(s.shape), s.dtype), jspec_nest)
  jstate = jdataset_io.dataset_to_replay(str(tmp_path), template, jreplay,
                                         jreplay.init())
  assert int(jstate.count) == FRAMES
  storage = jax.device_get(jstate.storage)
  for field in FIELDS:
    want = _expected(frames, field)
    got = getattr(storage, field)
    if isinstance(want, dict):
      for k in want:
        assert_equal(np.asarray(got[k])[:FRAMES], want[k], f"{field}.{k}")
    else:
      assert_equal(np.asarray(got)[:FRAMES], want, field)


def test_unbatched_frames_broadcast_to_every_row(tmp_path):
  """Frames without a batch dim, as a host driver writes them one env at a
  time, fill every replay row."""
  frames = _frames(False, n=7, batch=())
  observer = jdataset_io.TrajectoryFileObserver(
      str(tmp_path), _data_spec(jspec, jts, jtj, False), frames_per_shard=4)
  for f in frames:
    observer(_jax_frame(f))
  observer.flush()
  spec = _data_spec(tspec, tts, ttj, False)
  replay = UniformReplay(spec, B, 8, device="cpu")
  rstate = dataset_io.dataset_to_replay(str(tmp_path), spec, replay,
                                        replay.init())
  assert rstate.count == 7
  for row in range(B):
    assert_equal(rstate.storage.observation[:7, row],
                 _expected(frames, "observation"))
  wrong = UniformReplay(spec, B + 1, 8, device="cpu")
  observer = dataset_io.TrajectoryFileObserver(str(tmp_path / "b"), spec)
  for f in _frames(False, n=2):
    observer(_torch_frame(f))
  observer.flush()
  with pytest.raises(ValueError, match="batch size"):
    dataset_io.dataset_to_replay(str(tmp_path / "b"), spec, wrong,
                                 wrong.init())


@pytest.mark.parametrize("chunks", [(5, 7), (11,), (3, 3, 3, 9)])
def test_add_sequence_matches_jax_across_a_ring_wrap(chunks):
  """Sequences into a ring of 8 per row: wrapping within a call, and one
  call longer than the ring, leave the same storage and count as the JAX
  replay's `add_sequence` (its scan of `add_batch`)."""
  spec_j = _data_spec(jspec, jts, jtj, False)
  spec_t = _data_spec(tspec, tts, ttj, False)
  jreplay = JaxUniformReplay(spec_j, B, 8)
  treplay = UniformReplay(spec_t, B, 8, device="cpu")
  jstate, tstate = jreplay.init(), treplay.init()
  add = jax.jit(jreplay.add_sequence)
  seed = 2
  for n in chunks:
    frames = _frames(False, n=n, seed=seed)
    seed += 1
    stacked = {f: _expected(frames, f) for f in FIELDS}
    jstate = add(jstate, jtj.Trajectory(policy_info=(), **{
        k: jnp.asarray(v) for k, v in stacked.items()}))
    tstate = treplay.add_sequence(tstate, ttj.Trajectory(policy_info=(), **{
        k: torch.from_numpy(v) for k, v in stacked.items()}))
  assert tstate.count == int(jstate.count) == sum(chunks)
  storage = jax.device_get(jstate.storage)
  for field in FIELDS:
    assert_equal(getattr(tstate.storage, field), getattr(storage, field),
                 field)
