"""The port's episodic replay and host (numpy) replay buffers against the JAX
package: twins of `tests/test_replay_extras.py`'s cases, and the two
packages side by side on the same frames.

`EpisodicReplay` is held exactly: slots, lengths, episode ids, the
cursor, the completed ids and the sampled episodes (the JAX package's
``jax.random.categorical`` uniforms replayed at "episode_slot") are
integers or copies of the frames, so nothing is rounded. The port assigns
fresh slots vectorized where the JAX package scans rows with a while loop;
random completion patterns over many ring wraps hold the two equal. The
numpy buffers, driven by one `np.random.RandomState`, store and sample
equal arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu import specs as jspecs
from agents_tpu.replay_buffers.episodic_replay import \
    CompletionCallback as JaxCompletionCallback
from agents_tpu.replay_buffers.episodic_replay import \
    EpisodicReplay as JaxEpisodicReplay
from agents_tpu.replay_buffers.py_uniform_replay import \
    PyHashedReplayBuffer as JaxPyHashedReplayBuffer
from agents_tpu.replay_buffers.py_uniform_replay import \
    PyUniformReplayBuffer as JaxPyUniformReplayBuffer
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch import specs
from agents_tpu_torch.replay_buffers.episodic_replay import (
    CompletionCallback, EpisodicReplay)
from agents_tpu_torch.replay_buffers.py_uniform_replay import (
    PyHashedReplayBuffer, PyUniformReplayBuffer)
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from test_torch_parity_utils import assert_equal, to_np

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _spec(lib, tlib):
  return tlib.Trajectory(
      step_type=lib.ArraySpec((), np.int32),
      observation=lib.ArraySpec((2,), np.float32),
      action=lib.ArraySpec((), np.int32),
      policy_info=(),
      next_step_type=lib.ArraySpec((), np.int32),
      reward=lib.ArraySpec((), np.float32),
      discount=lib.ArraySpec((), np.float32))


SPEC = _spec(specs, tj)
JSPEC = _spec(jspecs, jtj)


def _frame_np(step_type, obs, next_step_type):
  b = len(step_type)
  return dict(step_type=np.asarray(step_type, np.int32),
              observation=np.asarray(obs, np.float32).reshape(b, 2),
              action=np.zeros(b, np.int32), policy_info=(),
              next_step_type=np.asarray(next_step_type, np.int32),
              reward=np.ones(b, np.float32), discount=np.ones(b, np.float32))


def _torch_frame(f):
  return tj.Trajectory(**{k: v if k == "policy_info" else torch.from_numpy(v)
                          for k, v in f.items()})


def _jax_frame(f):
  return jtj.Trajectory(**{k: v if k == "policy_info" else jnp.asarray(v)
                           for k, v in f.items()})


def _frame(B, t, done):
  return _torch_frame(_frame_np([0 if t == 0 else 1] * B,
                                np.full((B, 2), float(t)),
                                [2 if done else 1] * B))


def _replay_categorical(key, s, num_slots):
  """`sample_episodes`' draw: ``jax.random.categorical``'s uniforms in
  [tiny, 1) over [S, num_slots]."""
  return np.asarray(jax.random.uniform(
      key, (s, num_slots), jnp.float32, minval=jnp.finfo(jnp.float32).tiny,
      maxval=1.0))


# -- twins of tests/test_replay_extras.py --------------------------------------


def test_episodic_replay_commit_and_sample():
  replay = EpisodicReplay(SPEC, batch_size=2, num_slots=8, max_episode_len=5,
                          **CPU)
  state = replay.init()
  for t, done in [(0, False), (1, False), (2, True)]:
    state = replay.add_batch(state, _frame(2, t, done))
  assert int(state.num_completed) == 2
  for t, done in [(0, False), (1, True)]:
    state = replay.add_batch(state, _frame(2, t, done))
  assert int(state.num_completed) == 4
  eps, mask = replay.sample_episodes(state, Draws(0, "cpu"), 6)
  assert tuple(eps.observation.shape) == (6, 5, 2)
  lens = mask.sum(dim=1).numpy()
  assert set(lens).issubset({2.0, 3.0})
  obs = eps.observation.numpy()
  for i in range(6):
    L = int(lens[i])
    np.testing.assert_array_equal(obs[i, :L, 0], np.arange(L))


def test_episodic_replay_ids_and_callbacks():
  replay = EpisodicReplay(SPEC, batch_size=2, num_slots=8, max_episode_len=5,
                          **CPU)
  state = replay.init()
  fired = []
  cb = CompletionCallback([fired.append])
  assert_equal(state.episode_ids[:2], [0, 1])
  state, done_ids = replay.add_batch(state, _frame(2, 0, False),
                                     return_completed=True)
  assert cb(done_ids) == 0 and fired == []
  state, done_ids = replay.add_batch(state, _frame(2, 1, True),
                                     return_completed=True)
  assert cb(done_ids) == 2
  assert fired == [0, 1]
  assert int(state.next_episode_id) == 4
  _, mask, info = replay.sample_episodes(state, Draws(1, "cpu"), 4,
                                         return_info=True)
  assert set(info["episode_ids"].tolist()).issubset({0, 1})
  assert_equal(mask.sum(dim=1), [2] * 4)


def test_episodic_replay_in_progress_sampling():
  replay = EpisodicReplay(SPEC, batch_size=2, num_slots=8, max_episode_len=5,
                          **CPU)
  state = replay.init()
  for t in range(3):
    state = replay.add_batch(state, _frame(2, t, False))
  assert int(state.num_completed) == 0
  eps, mask, info = replay.sample_episodes(
      state, Draws(0, "cpu"), 4, completed_only=False, return_info=True)
  assert_equal(mask.sum(dim=1), [3] * 4)
  obs = eps.observation.numpy()
  for i in range(4):
    np.testing.assert_array_equal(obs[i, :3, 0], np.arange(3))
  assert set(info["episode_ids"].tolist()).issubset({0, 1})


def test_episodic_replay_add_sequence():
  replay = EpisodicReplay(SPEC, batch_size=1, num_slots=4, max_episode_len=6,
                          **CPU)
  state = replay.init()
  T = 4
  seq = tj.Trajectory(
      step_type=torch.tensor([0, 1, 1, 1], dtype=torch.int32),
      observation=torch.arange(T * 2, dtype=torch.float32).reshape(T, 2),
      action=torch.arange(T, dtype=torch.int32), policy_info=(),
      next_step_type=torch.tensor([1, 1, 1, 2], dtype=torch.int32),
      reward=torch.ones(T), discount=torch.ones(T))
  state = replay.add_sequence(state, seq)
  assert int(state.num_completed) == 1
  eps, mask, info = replay.sample_episodes(state, Draws(0, "cpu"), 2,
                                           return_info=True)
  assert_equal(mask.sum(dim=1), [4, 4])
  np.testing.assert_array_equal(eps.observation[0, :4].numpy(),
                                np.arange(8, dtype=np.float32).reshape(4, 2))
  assert set(info["episode_ids"].tolist()) == {1}


def test_episodic_fresh_slot_skips_open_slots():
  """After the slot ring wraps, a completing row's fresh slot skips slots
  still open for other rows and just-committed ones."""
  replay = EpisodicReplay(SPEC, batch_size=2, num_slots=8, max_episode_len=4,
                          **CPU)
  state = replay.init()
  for t in range(20):  # row 0 completes every other frame; row 1 never
    state = replay.add_batch(state, _torch_frame(_frame_np(
        [0, 0], [[t, t], [100.0 + t, 100.0 + t]],
        [2 if t % 2 == 1 else 1, 1])))
  open0, open1 = state.open_slot.tolist()
  assert open0 != open1
  n1 = int(state.open_len[1])
  row1_frames = state.storage.observation[open1][:n1].numpy()
  assert n1 > 0 and np.all(row1_frames >= 100.0), row1_frames


def test_episodic_rejects_too_few_slots():
  spec = {"x": specs.ArraySpec((), np.float32)}
  with pytest.raises(ValueError):
    EpisodicReplay(spec, batch_size=4, num_slots=8, max_episode_len=4, **CPU)


def test_py_uniform_replay():
  buf = PyUniformReplayBuffer({"x": specs.ArraySpec((), np.int32)}, 8)
  for i in range(12):
    buf.add({"x": np.asarray(i, np.int32)})
  assert len(buf) == 8
  out = buf.sample(64, rng=np.random.RandomState(0))
  assert out["x"].min() >= 4
  seq = buf.sample(16, num_steps=2, rng=np.random.RandomState(1))
  np.testing.assert_array_equal(seq["x"][:, 1], seq["x"][:, 0] + 1)
  np.testing.assert_array_equal(buf.gather_all()["x"], np.arange(4, 12))


def test_py_hashed_replay_dedups():
  spec = {"observation": specs.ArraySpec((4,), np.uint8),
          "action": specs.ArraySpec((), np.int32)}
  buf = PyHashedReplayBuffer(spec, 16)
  frame = np.ones(4, np.uint8)
  for i in range(10):
    buf.add({"observation": frame, "action": np.asarray(i, np.int32)})
  assert buf.num_unique_observations == 1
  assert buf.observation_bytes_stored == 4
  out = buf.sample(8, rng=np.random.RandomState(0))
  np.testing.assert_array_equal(out["observation"], np.ones((8, 4), np.uint8))
  assert out["action"].max() < 10


def test_py_hashed_replay_distinct_frames_roundtrip():
  spec = {"observation": specs.ArraySpec((3,), np.uint8),
          "action": specs.ArraySpec((), np.int32)}
  buf = PyHashedReplayBuffer(spec, 8)
  for i in range(12):
    buf.add({"observation": np.full(3, i, np.uint8),
             "action": np.asarray(i, np.int32)})
  # Overwritten frames are evicted: the pool stays O(capacity).
  assert buf.num_unique_observations == 8
  assert buf.observation_bytes_stored == 8 * 3
  out = buf.sample(32, rng=np.random.RandomState(1))
  np.testing.assert_array_equal(
      out["observation"],
      np.repeat(out["action"].astype(np.uint8)[:, None], 3, axis=1))
  ga = buf.gather_all()
  np.testing.assert_array_equal(ga["action"], np.arange(4, 12))
  np.testing.assert_array_equal(ga["observation"][:, 0],
                                np.arange(4, 12).astype(np.uint8))


def test_py_uniform_add_batch_vectorized_wraparound():
  buf = PyUniformReplayBuffer({"x": specs.ArraySpec((), np.int32)}, 10)
  buf.add_batch({"x": np.arange(6, dtype=np.int32)})
  buf.add_batch({"x": np.arange(6, 12, dtype=np.int32)})
  np.testing.assert_array_equal(buf.gather_all()["x"], np.arange(2, 12))
  buf.add_batch({"x": np.arange(100, 125, dtype=np.int32)})
  np.testing.assert_array_equal(buf.gather_all()["x"], np.arange(115, 125))


def test_py_uniform_interleaved_writer_stride():
  """writer_batch_size=B: multi-step windows stay inside one env's stream;
  a mismatched leading dim is refused."""
  spec = {"env": specs.ArraySpec((), np.int32),
          "t": specs.ArraySpec((), np.int32)}
  buf = PyUniformReplayBuffer(spec, 64, writer_batch_size=4)
  for t in range(20):
    buf.add_batch({"env": np.arange(4, dtype=np.int32),
                   "t": np.full(4, t, np.int32)})
  seq = buf.sample(256, num_steps=3, rng=np.random.RandomState(0))
  np.testing.assert_array_equal(seq["env"][:, 1], seq["env"][:, 0])
  np.testing.assert_array_equal(seq["env"][:, 2], seq["env"][:, 0])
  np.testing.assert_array_equal(seq["t"][:, 1], seq["t"][:, 0] + 1)
  np.testing.assert_array_equal(seq["t"][:, 2], seq["t"][:, 0] + 2)
  hspec = {"observation": specs.ArraySpec((2,), np.uint8),
           "t": specs.ArraySpec((), np.int32)}
  hbuf = PyHashedReplayBuffer(hspec, 32, writer_batch_size=2)
  for t in range(12):
    hbuf.add_batch({"observation": np.stack(
        [np.full(2, t, np.uint8), np.full(2, 100 + t, np.uint8)]),
        "t": np.full(2, t, np.int32)})
  seq = hbuf.sample(64, num_steps=2, rng=np.random.RandomState(1))
  np.testing.assert_array_equal(seq["t"][:, 1], seq["t"][:, 0] + 1)
  same_env = (seq["observation"][:, 1, 0].astype(np.int32)
              - seq["observation"][:, 0, 0].astype(np.int32))
  np.testing.assert_array_equal(same_env, np.ones_like(same_env))
  with pytest.raises(ValueError):
    buf.add_batch({"env": np.arange(3, dtype=np.int32),
                   "t": np.zeros(3, np.int32)})
  with pytest.raises(ValueError):
    buf.add({"env": np.asarray(0, np.int32), "t": np.asarray(0, np.int32)})


# -- side by side with the JAX package -----------------------------------------


def _episodic_state_equal(ts, js, err=""):
  for name in ("lengths", "episode_ids", "next_slot", "next_episode_id",
               "open_slot", "open_len", "num_completed"):
    assert_equal(getattr(ts, name), getattr(js, name), f"{err}{name}")
  for name in ("step_type", "observation", "action", "next_step_type",
               "reward", "discount"):
    assert_equal(getattr(ts.storage, name), getattr(js.storage, name),
                 f"{err}storage.{name}")


@pytest.mark.parametrize("B,num_slots,p_done", [(2, 5, 0.5), (4, 9, 0.3),
                                                (8, 17, 0.9), (3, 12, 0.1)])
def test_episodic_slot_assignment_matches_jax_scan(B, num_slots, p_done):
  """Random completion patterns over many ring wraps, episodes longer than
  their slots included: the vectorized assignment gives the JAX scan's
  slots, lengths, ids, cursor and completed ids at every call; then
  `add_sequence` and `sample_episodes` (both `completed_only` settings)
  from replayed draws agree."""
  rng = np.random.RandomState(B * 100 + num_slots)
  tr = EpisodicReplay(SPEC, B, num_slots, max_episode_len=5, **CPU)
  jr = JaxEpisodicReplay(JSPEC, B, num_slots, max_episode_len=5)
  ts, js = tr.init(), jr.init()
  jadd = jax.jit(lambda s, f: jr.add_batch(s, f, return_completed=True))
  for t in range(60):
    f = _frame_np(rng.randint(0, 2, B), rng.randn(B, 2),
                  np.where(rng.rand(B) < p_done, 2, 1))
    ts, tdone = tr.add_batch(ts, _torch_frame(f), return_completed=True)
    js, jdone = jadd(js, _jax_frame(f))
    assert_equal(tdone, jdone, f"completed ids at {t}")
    _episodic_state_equal(ts, js, f"call {t}: ")
  assert int(ts.num_completed) > num_slots     # the ring wrapped
  seq = _frame_np(np.zeros(3), rng.randn(3, 2), [1, 1, 2])
  ts = tr.add_sequence(ts, _torch_frame(seq), length=2)
  js = jax.jit(jr.add_sequence)(js, _jax_frame(seq), 2)
  _episodic_state_equal(ts, js, "add_sequence: ")
  for k, completed_only in enumerate((True, False)):
    key = jax.random.key(k)
    jeps, jmask, jinfo = jr.sample_episodes(
        js, key, 16, completed_only=completed_only, return_info=True)
    teps, tmask, tinfo = tr.sample_episodes(
        ts, ReplayDraws({"episode_slot": [_replay_categorical(
            key, 16, num_slots)]}), 16, completed_only=completed_only,
        return_info=True)
    assert_equal(tmask, jmask)
    for name in ("episode_ids", "lengths", "slots"):
      assert_equal(tinfo[name], jinfo[name], name)
    assert_equal(teps.observation, jeps.observation)


def test_completion_callback_fires_as_jax_does():
  fired_t, fired_j = [], []
  ids = np.array([5, -1, 3, -1, 9], np.int32)
  assert CompletionCallback([fired_t.append])(torch.from_numpy(ids)) == \
      JaxCompletionCallback([fired_j.append])(jnp.asarray(ids)) == 3
  assert fired_t == fired_j == [3, 5, 9]


@pytest.mark.parametrize("hashed", [False, True])
def test_py_buffers_store_and_sample_as_jax_does(hashed):
  """The same frames, dict keys out of order included, through the port's
  and the JAX package's buffer, and one RandomState each: equal
  `gather_all`, equal samples (single frames and strided 2-step
  windows), and for the hashed buffer the same pool."""
  spec_t = {"t": specs.ArraySpec((), np.int32),
            "observation": specs.ArraySpec((3,), np.uint8),
            "a": specs.ArraySpec((2,), np.float32)}
  spec_j = {"t": jspecs.ArraySpec((), np.int32),
            "observation": jspecs.ArraySpec((3,), np.uint8),
            "a": jspecs.ArraySpec((2,), np.float32)}
  cls_t = PyHashedReplayBuffer if hashed else PyUniformReplayBuffer
  cls_j = JaxPyHashedReplayBuffer if hashed else JaxPyUniformReplayBuffer
  bt, bj = cls_t(spec_t, 40, writer_batch_size=4), cls_j(spec_j, 40,
                                                         writer_batch_size=4)
  rng = np.random.RandomState(0)
  for t in range(15):
    batch = {"t": np.full(4, t, np.int32),
             "observation": rng.randint(0, 3, (4, 3)).astype(np.uint8),
             "a": rng.randn(4, 2).astype(np.float32)}
    bt.add_batch(batch)
    bj.add_batch(batch)
  gt, gj = bt.gather_all(), bj.gather_all()
  assert set(gt) == set(gj)
  for k in gj:
    np.testing.assert_array_equal(gt[k], np.asarray(gj[k]), err_msg=k)
  for num_steps in (None, 2):
    st = bt.sample(32, num_steps=num_steps, rng=np.random.RandomState(7))
    sj = bj.sample(32, num_steps=num_steps, rng=np.random.RandomState(7))
    for k in sj:
      np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
  if hashed:
    assert bt.num_unique_observations == bj.num_unique_observations
    assert bt.observation_bytes_stored == bj.observation_bytes_stored


def test_py_buffer_reuses_sample_buffers_double_buffered():
  """`reuse_sample_buffers`: a batch stays valid until the second
  following sample, as in the JAX class."""
  spec = {"x": specs.ArraySpec((2,), np.int32)}
  buf = PyUniformReplayBuffer(spec, 16, reuse_sample_buffers=True)
  buf.add_batch({"x": np.arange(32, dtype=np.int32).reshape(16, 2)})
  a = buf.sample(4, rng=np.random.RandomState(0))["x"]
  a_copy = a.copy()
  b = buf.sample(4, rng=np.random.RandomState(1))["x"]
  np.testing.assert_array_equal(a, a_copy)          # still valid
  c = buf.sample(4, rng=np.random.RandomState(2))["x"]
  assert np.shares_memory(a, c) and not np.shares_memory(a, b)


def test_py_buffer_trajectory_leaves_in_jax_order():
  """A Trajectory frame round trips through the hashed buffer (its
  observation in the pool, the rest in the ring) as a Trajectory."""
  buf = PyHashedReplayBuffer(SPEC, 8)
  f = _frame_np([0, 1], [[1, 2], [3, 4]], [1, 2])
  buf.add_batch(tj.Trajectory(**f))
  out = buf.sample(6, rng=np.random.RandomState(0))
  assert isinstance(out, tj.Trajectory)
  assert out.observation.shape == (6, 2)
  rows = np.where(out.step_type == 0, 0, 1)
  np.testing.assert_array_equal(out.observation, f["observation"][rows])
  np.testing.assert_array_equal(out.next_step_type, f["next_step_type"][rows])
  assert to_np(torch.from_numpy(out.reward)).shape == (6,)
