"""Host-side (numpy) replay buffers.

Port of ``agents_tpu/replay_buffers/py_uniform_replay.py``:
`PyUniformReplayBuffer`, a thread-safe numpy ring (the writer-stride
contract, `reuse_sample_buffers`, the hugepage-backed `_alloc_storage`),
and `PyHashedReplayBuffer`, which stores each distinct observation once.
They answer Atari-scale capacities (1M frames of 84x84x4 uint8 are 28 GB)
in host RAM: frames live here, and sampled batches move to the device per
train step. Leaves are laid out and returned in the JAX package's order
(``nest_utils.flatten_sorted`` / ``unflatten_sorted``: a dict's keys
sorted), so both packages store and sample identically from one
`np.random.RandomState`.
"""
from __future__ import annotations

import dataclasses
import hashlib
import mmap
import threading
from typing import Optional

import numpy as np

from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils


def _alloc_storage(shape, dtype, keepalive: list):
  """Allocate a storage leaf, hugepage-backed when large.

  Random row gathers over a multi-GB ring are TLB-bound with 4 KB pages;
  MADV_HUGEPAGE lets the kernel back the arena with 2 MB pages. Falls
  back to plain np.zeros when mmap or madvise is unavailable."""
  nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
  if nbytes >= (1 << 25):  # 32 MB: below this, page pressure is moot
    try:
      mm = mmap.mmap(-1, nbytes)
      mm.madvise(mmap.MADV_HUGEPAGE)
      keepalive.append(mm)
      return np.frombuffer(mm, dtype=dtype).reshape(shape)
    except (OSError, ValueError, AttributeError):
      pass
  return np.zeros(shape, dtype)


class PyUniformReplayBuffer:
  """Thread-safe numpy ring over spec-conforming frames.

  `writer_batch_size` declares what the leading dimension of
  `add_batch` means, because the ring layout differs:

  - ``writer_batch_size=1`` (default): `add_batch` appends a
    TIME-CONTIGUOUS chunk of frames from one stream (bulk fill); ring
    slot t+1 is the next timestep after slot t.
  - ``writer_batch_size=B>1``: each `add_batch` call is ONE timestep
    across B parallel envs (the PyDriver observer cadence), so the ring
    interleaves envs and the next timestep of the same env is B slots
    ahead. Multi-step `sample(num_steps=n)` windows then stride by B so
    every window stays inside one env's stream — without this, windows
    pair env i's frame at t with env i+1's frame at t, producing
    incoherent transitions (cross-env `next_observation`).
  """

  def __init__(self, data_spec, capacity: int, writer_batch_size: int = 1,
               reuse_sample_buffers: bool = False):
    self.data_spec = data_spec
    self.capacity = capacity
    self.writer_batch_size = int(writer_batch_size)
    # reuse_sample_buffers=True returns batches backed by a
    # double-buffered pool (zero steady-state allocation; a batch stays
    # valid until the SECOND following sample() call). Default False:
    # fresh arrays per call, safe for callers that retain batches.
    self.reuse_sample_buffers = bool(reuse_sample_buffers)
    self._lock = threading.Lock()
    self._mmaps: list = []
    self._storage = array_spec.map_spec_nest(
        lambda s: _alloc_storage((capacity,) + s.shape, s.dtype,
                                 self._mmaps), data_spec)
    self._count = 0
    # Gather fast path: 2-D row views of each storage leaf (np.take on a
    # [capacity, row_bytes] view instead of fancy indexing the N-D array)
    # and a double-buffered output pool, so steady-state sampling never
    # allocates.
    self._flat_views = [s.reshape(capacity, -1) if s.ndim > 1 else s
                        for s in nest_utils.flatten_sorted(self._storage)]
    self._out_pool: dict = {}

  def _gather_rows(self, flat_idx: np.ndarray):
    """Gather rows `flat_idx` from every leaf via the 2-D row views.

    Returns leaf arrays shaped [len(flat_idx), *leaf_shape]. With
    `reuse_sample_buffers`, output comes from a double-buffered pool
    (valid until the second following call); otherwise fresh arrays.

    Indices are already reduced mod capacity; they are bounds-checked
    ONCE here (one vectorized compare over len(flat_idx) ints) so take()
    can run with mode='clip' instead of mode='raise', which re-checks per
    element on a slow path.
    """
    n = len(flat_idx)
    if n and not ((flat_idx >= 0) & (flat_idx < self.capacity)).all():
      raise IndexError(f"replay gather index out of range "
                       f"[0, {self.capacity})")
    out_leaves = []
    for li, (slot, view) in enumerate(
        zip(nest_utils.flatten_sorted(self._storage), self._flat_views)):
      if self.reuse_sample_buffers:
        key = (li, n)
        pool = self._out_pool.get(key)
        if pool is None:
          pool = [np.empty((n,) + view.shape[1:], view.dtype)
                  for _ in range(2)], [0]
          self._out_pool[key] = pool
        bufs, turn = pool
        buf = bufs[turn[0]]
        turn[0] ^= 1
      else:
        buf = np.empty((n,) + view.shape[1:], view.dtype)
      np.take(view, flat_idx, axis=0, out=buf, mode="clip")
      out_leaves.append(buf.reshape((n,) + slot.shape[1:]))
    return out_leaves

  def __len__(self):
    return min(self._count, self.capacity)

  def _check_writer_batch(self, b: Optional[int] = None):
    """Enforce the interleave contract (class docstring): b=None means a
    single-frame add()."""
    if self.writer_batch_size <= 1:
      return
    if b is None:
      raise ValueError("single-frame add() would shift the env "
                       "interleave; use add_batch with leading dim "
                       f"{self.writer_batch_size}")
    if b != self.writer_batch_size:
      raise ValueError(
          f"add_batch leading dim {b} != writer_batch_size "
          f"{self.writer_batch_size}; multi-step sampling relies on a "
          "constant interleave stride")

  def add(self, item):
    self._check_writer_batch()
    with self._lock:
      idx = self._count % self.capacity
      leaves = nest_utils.flatten_sorted(item)
      slots = nest_utils.flatten_sorted(self._storage)
      for slot, leaf in zip(slots, leaves):
        slot[idx] = np.asarray(leaf)
      self._count += 1

  def add_batch(self, items):
    """Vectorized contiguous ring write (wraparound-split into at most
    two slice copies per leaf) — a batch of B frames is B rows of one
    memcpy, not B python-level add() calls."""
    leaves = [np.asarray(x) for x in nest_utils.flatten_sorted(items)]
    b = leaves[0].shape[0]
    self._check_writer_batch(b)
    if b > self.capacity:  # only the last `capacity` rows survive anyway
      leaves = [x[-self.capacity:] for x in leaves]
      skipped, b = b - self.capacity, self.capacity
    else:
      skipped = 0
    with self._lock:
      self._count += skipped
      start = self._count % self.capacity
      n1 = min(b, self.capacity - start)
      slots = nest_utils.flatten_sorted(self._storage)
      for slot, leaf in zip(slots, leaves):
        slot[start:start + n1] = leaf[:n1]
        if n1 < b:
          slot[:b - n1] = leaf[n1:]
      self._count += b

  def _sample_indices(self, batch_size, num_steps, rng):
    rng = rng or np.random
    size = len(self)
    n = num_steps or 1
    stride = self.writer_batch_size  # same-env adjacency (see class doc)
    lo = self._count - size
    hi = self._count - (n - 1) * stride
    if hi <= lo:
      raise ValueError("Not enough frames to sample")
    t0 = rng.randint(lo, hi, size=batch_size)
    return (t0[:, None] + np.arange(n)[None, :] * stride) % self.capacity

  def sample(self, batch_size: int, num_steps: Optional[int] = None,
             rng: Optional[np.random.RandomState] = None):
    with self._lock:
      idx = self._sample_indices(batch_size, num_steps, rng)
      leaves = self._gather_rows(idx.reshape(-1))
      n = num_steps or 1
      if num_steps is None:
        shaped = leaves
      else:
        shaped = [l.reshape((batch_size, n) + l.shape[1:]) for l in leaves]
      return nest_utils.unflatten_sorted(self._storage, shaped)

  def gather_all(self):
    with self._lock:
      size = len(self)
      start = (self._count - size) % self.capacity
      order = (np.arange(size) + start) % self.capacity
      return nest_utils.tree_map(lambda s: s[order], self._storage)

  def clear(self):
    with self._lock:
      self._count = 0


class PyHashedReplayBuffer(PyUniformReplayBuffer):
  """Deduplicates identical observation frames by content hash: repeated
  Atari frames store ONE copy (reference py_hashed_replay_buffer.py —
  with FrameStack4, consecutive stacks share 3 of 4 planes when stacking
  is done at sample time; here dedup is at whole-observation granularity,
  which collapses e.g. repeated still frames).

  Observations are NOT in the dense ring: the ring stores a pool index
  per slot and the pool keeps one copy per distinct frame; `sample`
  reconstructs observations from the pool."""

  def __init__(self, data_spec, capacity: int, writer_batch_size: int = 1,
               reuse_sample_buffers: bool = False):
    self.data_spec = data_spec
    self.capacity = capacity
    self.writer_batch_size = int(writer_batch_size)
    self.reuse_sample_buffers = bool(reuse_sample_buffers)
    self._lock = threading.Lock()
    # Dense ring for everything EXCEPT the observation.
    rest_spec = self._strip_obs(data_spec)
    self._mmaps: list = []
    self._storage = array_spec.map_spec_nest(
        lambda s: _alloc_storage((capacity,) + s.shape, s.dtype,
                                 self._mmaps), rest_spec)
    self._count = 0
    self._flat_views = [s.reshape(capacity, -1) if s.ndim > 1 else s
                        for s in nest_utils.flatten_sorted(self._storage)]
    self._out_pool = {}
    self._obs_out_pool: list = []
    # Refcounted dedup pool (the reference py_hashed_replay_buffer also
    # evicts when the last ring slot referencing a frame is overwritten
    # — without eviction a long run retains every frame ever seen, not
    # `capacity` frames). _pool: hash -> pool index; _pool_list[i] is
    # the frame (None when free); _pool_hash/_pool_refs parallel it;
    # _free recycles pool slots.
    self._pool: dict = {}
    self._pool_list: list = []
    self._pool_hash: list = []
    self._pool_refs: list = []
    self._free: list = []
    self._obs_idx = np.zeros((capacity,), np.int64)

  @staticmethod
  def _get_obs(item):
    return (item.observation if hasattr(item, "observation")
            else item["observation"])

  @staticmethod
  def _strip_obs(item):
    if dataclasses.is_dataclass(item):
      return dataclasses.replace(item, observation=())
    return {k: v for k, v in item.items() if k != "observation"}

  @staticmethod
  def _with_obs(rest, obs):
    if dataclasses.is_dataclass(rest):
      return dataclasses.replace(rest, observation=obs)
    return dict(rest, observation=obs)

  def _pool_insert(self, obs: np.ndarray) -> int:
    h = hashlib.blake2b(obs.tobytes(), digest_size=16).digest()
    pool_idx = self._pool.get(h)
    if pool_idx is None:
      if self._free:
        pool_idx = self._free.pop()
        self._pool_list[pool_idx] = obs.copy()
        self._pool_hash[pool_idx] = h
        self._pool_refs[pool_idx] = 0
      else:
        pool_idx = len(self._pool_list)
        self._pool_list.append(obs.copy())
        self._pool_hash.append(h)
        self._pool_refs.append(0)
      self._pool[h] = pool_idx
    self._pool_refs[pool_idx] += 1
    return pool_idx

  def _pool_release(self, pool_idx: int):
    self._pool_refs[pool_idx] -= 1
    if self._pool_refs[pool_idx] == 0:
      del self._pool[self._pool_hash[pool_idx]]
      self._pool_list[pool_idx] = None
      self._pool_hash[pool_idx] = None
      self._free.append(pool_idx)

  def _write_one(self, rest_leaves_at, obs_frame):
    """Write one frame at the current ring head (lock held)."""
    idx = self._count % self.capacity
    for slot, leaf in zip(nest_utils.flatten_sorted(self._storage),
                          rest_leaves_at):
      slot[idx] = leaf
    if self._count >= self.capacity:  # overwriting: release old frame
      self._pool_release(int(self._obs_idx[idx]))
    self._obs_idx[idx] = self._pool_insert(obs_frame)
    self._count += 1

  def add(self, item):
    self._check_writer_batch()
    obs = np.asarray(self._get_obs(item))
    rest = self._strip_obs(item)
    with self._lock:
      self._write_one([np.asarray(l) for l in
                       nest_utils.flatten_sorted(rest)], obs)

  def add_batch(self, items):
    obs = np.asarray(self._get_obs(items))
    rest = self._strip_obs(items)
    rest_leaves = [np.asarray(l) for l in nest_utils.flatten_sorted(rest)]
    b = obs.shape[0]
    self._check_writer_batch(b)
    with self._lock:
      for i in range(b):
        self._write_one([l[i] for l in rest_leaves], obs[i])

  def sample(self, batch_size: int, num_steps: Optional[int] = None,
             rng: Optional[np.random.RandomState] = None):
    with self._lock:
      idx = self._sample_indices(batch_size, num_steps, rng)
      flat = idx.reshape(-1)
      rest_leaves = self._gather_rows(flat)
      n = num_steps or 1
      # Observation gather from the dedup pool (double-buffered output
      # under reuse_sample_buffers, same contract as _gather_rows).
      first = self._pool_list[self._obs_idx[flat[0]]]
      if self.reuse_sample_buffers:
        if len(self._obs_out_pool) != 2 or \
            self._obs_out_pool[0].shape != (len(flat),) + first.shape:
          self._obs_out_pool = [
              np.empty((len(flat),) + first.shape, first.dtype)
              for _ in range(2)]
          self._obs_turn = 0
        obs = self._obs_out_pool[self._obs_turn]
        self._obs_turn ^= 1
      else:
        obs = np.empty((len(flat),) + first.shape, first.dtype)
      pool_list, obs_idx = self._pool_list, self._obs_idx
      for j, i in enumerate(flat):
        obs[j] = pool_list[obs_idx[i]]
      if num_steps is not None:
        rest_leaves = [l.reshape((batch_size, n) + l.shape[1:])
                       for l in rest_leaves]
        obs = obs.reshape((batch_size, n) + obs.shape[1:])
      rest = nest_utils.unflatten_sorted(self._storage, rest_leaves)
      return self._with_obs(rest, obs)

  def gather_all(self):
    with self._lock:
      size = len(self)
      start = (self._count - size) % self.capacity
      order = (np.arange(size) + start) % self.capacity
      rest = nest_utils.tree_map(lambda s: s[order], self._storage)
      obs = np.stack([self._pool_list[self._obs_idx[i]] for i in order]) \
          if size else np.zeros((0,))
      return self._with_obs(rest, obs)

  def clear(self):
    with self._lock:
      self._count = 0
      self._pool.clear()
      self._pool_list.clear()
      self._pool_hash.clear()
      self._pool_refs.clear()
      self._free.clear()

  @property
  def num_unique_observations(self):
    return len(self._pool_list) - len(self._free)

  @property
  def observation_bytes_stored(self):
    return sum(o.nbytes for o in self._pool_list if o is not None)
