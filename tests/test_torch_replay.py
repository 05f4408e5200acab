"""Port parity: the uniform replay ring (`agents_tpu_torch.replay_buffers`,
`agents_tpu_torch.ops.replay_gather`) against the JAX package.

The JAX side's sample draws are read back from its `BufferInfo` (window
starts `ids` and env `rows`) and replayed into the port; stored and
sampled values are compared exactly (the replay only moves data).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agents_tpu.replay_buffers import uniform_replay as jreplay
from agents_tpu.specs import array_spec as jspec
from agents_tpu_torch.ops.replay_gather import gather_rows
from agents_tpu_torch.replay_buffers import UniformReplay
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.utils.draws import Draws, ReplayDraws
from test_torch_parity_utils import assert_close, assert_equal

torch.set_num_threads(1)

B, CAP = 4, 8


def _specs(module):
  return {"obs": module.ArraySpec((3,), np.float32),
          "a": module.BoundedArraySpec((), np.int32, 0, 1)}


def _frames(n, seed=0):
  rng = np.random.RandomState(seed)
  return [{"obs": rng.randn(B, 3).astype(np.float32),
           "a": rng.randint(0, 2, B).astype(np.int32)} for _ in range(n)]


def _filled(num_frames):
  jrb = jreplay.UniformReplay(_specs(jspec), B, CAP)
  trb = UniformReplay(_specs(tspec), B, CAP, device="cpu")
  jstate, tstate = jrb.init(), trb.init()
  for f in _frames(num_frames):
    jstate = jrb.add_batch(jstate, {k: jnp.asarray(v) for k, v in f.items()})
    tstate = trb.add_batch(tstate, {k: torch.from_numpy(v)
                                    for k, v in f.items()})
  return (jrb, jstate), (trb, tstate)


@pytest.mark.parametrize("num_frames", [5, 13, 24])
def test_add_batch_matches_jax_across_wraparound(num_frames):
  (jrb, jstate), (trb, tstate) = _filled(num_frames)
  assert tstate.count == int(jstate.count) == num_frames
  assert trb.size(tstate) == int(jrb.size(jstate))
  for k in ("obs", "a"):
    assert_equal(tstate.storage[k], jstate.storage[k], k)
  jall, tall = jrb.gather_all(jstate), trb.gather_all(tstate)
  for k in ("obs", "a"):
    assert_equal(tall[k], jall[k], k)


@pytest.mark.parametrize("num_frames,num_steps", [(5, 2), (13, 2), (13, None),
                                                  (24, 3)])
def test_sample_matches_jax_with_replayed_draws(num_frames, num_steps):
  (jrb, jstate), (trb, tstate) = _filled(num_frames)
  s = 16
  jbatch, jinfo = jrb.sample(jstate, jax.random.key(num_frames), s,
                             num_steps=num_steps)
  lo = num_frames - min(num_frames, CAP)
  draws = ReplayDraws({"replay_t0": [np.asarray(jinfo.ids) - lo],
                       "replay_rows": [np.asarray(jinfo.rows)]})
  tbatch, tinfo = trb.sample(tstate, draws, s, num_steps=num_steps)
  for k in ("obs", "a"):
    assert_equal(tbatch[k], jbatch[k], k)
  assert_equal(tinfo.ids, jinfo.ids)
  assert_equal(tinfo.rows, jinfo.rows)
  assert_close(tinfo.probabilities, jinfo.probabilities)
  n = 1 if num_steps is None else num_steps
  num_valid = min(num_frames, CAP) - n + 1
  assert_close(tinfo.probabilities, np.full(s, 1.0 / (num_valid * B),
                                            np.float32))


def test_sample_windows_cover_exactly_the_valid_range():
  """t0 ~ U[count - size, count - n] and rows ~ U[0, B), wrapped or not."""
  _, (trb, tstate) = _filled(13)
  _, info = trb.sample(tstate, Draws(0, "cpu"), 4000, num_steps=2)
  assert set(info.ids.tolist()) == set(range(13 - CAP, 13 - 2 + 1))
  assert set(info.rows.tolist()) == set(range(B))
  # A window's two frames are consecutive in time for its env row.
  batch, info = trb.sample(tstate, Draws(1, "cpu"), 64, num_steps=2)
  storage = tstate.storage["obs"]
  t = info.ids % CAP
  assert_equal(batch["obs"][:, 0], storage[t, info.rows])
  assert_equal(batch["obs"][:, 1], storage[(t + 1) % CAP, info.rows])


def test_sample_errors_match_jax():
  (jrb, jstate), (trb, tstate) = _filled(1)
  for rb, st, key in ((jrb, jstate, jax.random.key(0)),
                      (trb, tstate, Draws(0, "cpu"))):
    with pytest.raises(ValueError, match="underfilled"):
      rb.sample(st, key, 4, num_steps=2)
    with pytest.raises(ValueError, match="exceeds ring capacity"):
      rb.sample(st, key, 4, num_steps=CAP + 1)


def test_clear_and_pack_large_rows_is_accepted():
  _, (trb, tstate) = _filled(13)
  cleared = trb.clear(tstate)
  assert cleared.count == 0 and trb.size(cleared) == 0
  rb = UniformReplay(_specs(tspec), B, CAP, pack_large_rows=False,
                     device="cpu")
  assert rb.init().storage["obs"].shape == (CAP, B, 3)


def test_gather_rows_is_an_index_select():
  table = torch.arange(24, dtype=torch.float32).reshape(6, 2, 2)
  idx = torch.tensor([5, 0, 5, 2])
  assert_equal(gather_rows(table, idx), table.numpy()[[5, 0, 5, 2]])
