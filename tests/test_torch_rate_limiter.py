"""The port's Reverb-style rate limiters (`replay_buffers/rate_limiter.py`):
twins of `tests/test_rate_limiter.py`, with the port's shared-memory ring
for the producer's blocking push, and the two packages' limiters making
the same decisions over one random run of inserts and samples."""
import os
import secrets
import threading
import time

import numpy as np
import pytest

from agents_tpu.replay_buffers import rate_limiter as jax_rate_limiter
from agents_tpu_torch.replay_buffers import rate_limiter
from agents_tpu_torch.replay_buffers.rate_limiter import (MinSize,
                                                          SampleToInsertRatio)


def test_min_size_blocks_until_filled():
  lim = MinSize(min_size_to_sample=4)
  assert not lim.can_sample(1)
  assert not lim.sample(1, timeout=0.05)
  assert lim.insert(3)
  assert not lim.can_sample(1)
  assert lim.insert(1)
  assert lim.can_sample(1)
  assert lim.sample(1, timeout=0.05)


def test_min_size_unblocks_waiting_sampler():
  lim = MinSize(min_size_to_sample=2)
  got = []
  t = threading.Thread(target=lambda: got.append(lim.sample(1, timeout=5.0)))
  t.start()
  time.sleep(0.05)
  assert not got
  lim.insert(2)
  t.join(timeout=5.0)
  assert not t.is_alive() and got == [True]


def test_ratio_blocks_fast_trainer():
  lim = SampleToInsertRatio(samples_per_insert=2.0, min_size_to_sample=2,
                            error_buffer=4.0)
  lim.insert(2)                               # d = 4; bounds [0, 8]
  assert lim.can_sample(4)
  assert lim.sample(4)
  assert not lim.can_sample(1)
  assert not lim.sample(1, timeout=0.05)
  lim.insert(1)
  assert lim.sample(2, timeout=0.05)


def test_ratio_blocks_fast_collector():
  lim = SampleToInsertRatio(samples_per_insert=2.0, min_size_to_sample=2,
                            error_buffer=4.0)
  lim.insert(2)
  assert lim.can_insert(2)
  lim.insert(2)                               # d = 8 = max_diff
  assert not lim.can_insert(1)
  assert not lim.insert(1, timeout=0.05)
  done = []
  t = threading.Thread(target=lambda: done.append(lim.insert(1, timeout=5.0)))
  t.start()
  time.sleep(0.05)
  assert not done
  lim.sample(4)
  t.join(timeout=5.0)
  assert not t.is_alive() and done == [True]


def test_ratio_deadlock_guard():
  with pytest.raises(ValueError):
    SampleToInsertRatio(samples_per_insert=10.0, min_size_to_sample=1,
                        error_buffer=(0.0, 5.0))
  with pytest.raises(ValueError):
    MinSize(0)


def test_push_blocking_waits_for_ring_space():
  from agents_tpu_torch.replay_buffers.host_ingest import (IngestClient,
                                                           IngestServer)
  from agents_tpu_torch.specs import array_spec

  spec = array_spec.ArraySpec((2,), np.float32, "x")
  name = f"trl_{os.getpid()}_{secrets.token_hex(4)}"
  server = IngestServer(name, spec, capacity=8)
  client = IngestClient(name, spec)
  try:
    frames = np.arange(16, dtype=np.float32).reshape(8, 2)
    assert client.push(frames) == 8
    assert client.push(frames[:1]) == 0
    assert server.dropped() == 1
    sent = []
    t = threading.Thread(
        target=lambda: sent.append(client.push_blocking(frames[:4],
                                                        timeout=5.0)))
    t.start()
    time.sleep(0.05)
    assert not sent
    assert server.drain(max_frames=4) is not None
    t.join(timeout=5.0)
    assert not t.is_alive() and sent == [4]
    assert server.dropped() == 1               # the blocking path never drops
    assert client.push_blocking(frames[:2], timeout=0.05) == 0
  finally:
    client.close()
    server.close()


@pytest.mark.parametrize("kind", ["min_size", "ratio", "ratio_bounds"])
def test_decisions_match_jax(kind):
  """One random run of gated inserts and samples through both packages'
  limiters: the same `can_insert` / `can_sample` answers at every step and
  the same counts at the end."""
  def build(lib):
    if kind == "min_size":
      return lib.MinSize(5)
    if kind == "ratio":
      return lib.SampleToInsertRatio(3.0, 4, 10.0)
    return lib.SampleToInsertRatio(0.5, 2, (-1.5, 6.0))

  port, ref = build(rate_limiter), build(jax_rate_limiter)
  rng = np.random.RandomState(0)
  for _ in range(400):
    n = int(rng.randint(1, 4))
    if rng.rand() < 0.5:
      assert port.can_insert(n) == ref.can_insert(n)
      if port.can_insert(n):
        port.record_insert(n)
        ref.record_insert(n)
    else:
      assert port.can_sample(n) == ref.can_sample(n)
      if port.can_sample(n):
        port.record_sample(n)
        ref.record_sample(n)
  assert (port.inserts, port.samples) == (ref.inserts, ref.samples)
  assert port.samples > 0
