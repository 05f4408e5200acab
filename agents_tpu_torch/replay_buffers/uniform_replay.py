"""On-device uniform replay: a ring buffer in device memory.

Port of ``agents_tpu/replay_buffers/uniform_replay.py`` (`init`,
`add_batch`, `sample`, `_gather`, `gather_all`, `clear`). Layout is
time-major ``[capacity, B, ...]`` per leaf, as in the JAX package.

The frame count is a host Python int, where the JAX package keeps a traced
int32 (and renormalises it, `renorm_count` :47). It is deterministic (+1
per `add_batch`), so the write slot, the valid window and the underfill
check need no device sync, and it cannot overflow. `add_batch` writes the
frame into the storage tensors in place: a ReplayState returned earlier
shares them.

Valid-window math (equal to the JAX package's at the same count):
  size = min(count, capacity)
  a window of `num_steps` starting at time t is valid iff
     count - size <= t  and  t + num_steps <= count
so t0 ~ U[count - size, count - num_steps], rows ~ U[0, B), and every
item has probability 1 / (num_valid * B).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from agents_tpu_torch.ops.replay_gather import gather_rows
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ReplayState:
  storage: Any   # nest of [capacity, B, ...] tensors
  count: int     # total frames added (host int)


class BufferInfo(NamedTuple):
  """Sample metadata."""
  ids: torch.Tensor            # [S] time ids of the window starts
  rows: torch.Tensor           # [S] env-row ids
  probabilities: torch.Tensor  # [S]


class UniformReplay:
  """Uniform-sampling ring buffer.

  Args:
    data_spec: spec nest for one (unbatched) frame.
    batch_size: number of parallel env rows B.
    max_length: ring capacity per row.
    pack_large_rows: accepted so configs carry over from the JAX package;
      it has no effect here (the [r, 128] packing is a TPU layout).
    device: where the storage lives; "cuda" unless the caller asks for
      "cpu".
  """

  def __init__(self, data_spec, batch_size: int, max_length: int,
               pack_large_rows: bool = True, device="cuda"):
    del pack_large_rows
    self.data_spec = data_spec
    self.batch_size = int(batch_size)
    self.capacity = int(max_length)
    self.device = resolve_device(device)

  def init(self) -> ReplayState:
    storage = array_spec.zero_spec_nest(
        self.data_spec, outer_dims=(self.capacity, self.batch_size),
        device=self.device)
    return ReplayState(storage=storage, count=0)

  def clear(self, state: ReplayState) -> ReplayState:
    return ReplayState(storage=state.storage, count=0)

  def size(self, state: ReplayState) -> int:
    return min(state.count, self.capacity)

  def add_batch(self, state: ReplayState, items) -> ReplayState:
    """Write one frame per env row (items: [B, ...]) at slot
    ``count % capacity``."""
    row = state.count % self.capacity
    nest_utils.tree_map(lambda s, x: s[row].copy_(x), state.storage, items)
    return ReplayState(storage=state.storage, count=state.count + 1)

  def sample(self, state: ReplayState, draws, sample_batch_size: int,
             num_steps: Optional[int] = None):
    """Uniform sample of windows.

    Returns (batch, BufferInfo). With `num_steps=None` batch leaves are
    [S, ...]; otherwise [S, num_steps, ...]. Draws "replay_t0" and
    "replay_rows" from `draws`.
    """
    n = 1 if num_steps is None else int(num_steps)
    if n > self.capacity:
      raise ValueError(
          f"sample(num_steps={n}) exceeds ring capacity {self.capacity}: "
          "windows longer than the ring cannot be time-contiguous")
    if state.count < n:
      raise ValueError(
          f"sample(num_steps={n}) on an underfilled replay buffer "
          f"(count={state.count}): wait for at least num_steps frames")
    size = self.size(state)
    lo = state.count - size                      # oldest valid time id
    num_valid = state.count - n + 1 - lo
    t0 = lo + draws.randint("replay_t0", (sample_batch_size,), 0, num_valid)
    rows = draws.randint("replay_rows", (sample_batch_size,), 0,
                         self.batch_size)
    batch = self._gather(state.storage, t0, rows, n)
    if num_steps is None:
      batch = nest_utils.tree_map(lambda x: x[:, 0], batch)
    probs = torch.full((sample_batch_size,),
                       1.0 / (num_valid * self.batch_size),
                       dtype=torch.float32, device=self.device)
    return batch, BufferInfo(ids=t0, rows=rows, probabilities=probs)

  def _gather(self, storage, t0, rows, n):
    """Gather [S, n, ...] windows by flat index into [capacity * B, ...]."""
    steps = torch.arange(n, device=t0.device)
    t_idx = (t0[:, None] + steps[None, :]) % self.capacity
    flat_idx = (t_idx * self.batch_size + rows[:, None]).reshape(-1)

    def leaf_gather(s):
      flat = s.reshape((self.capacity * self.batch_size,) + s.shape[2:])
      out = gather_rows(flat, flat_idx)
      return out.reshape((t_idx.shape[0], n) + s.shape[2:])

    return nest_utils.tree_map(leaf_gather, storage)

  def gather_all(self, state: ReplayState):
    """All frames, batch-major [B, capacity, ...], oldest first."""
    start = state.count % self.capacity if state.count >= self.capacity else 0
    order = (torch.arange(self.capacity, device=self.device) + start) \
        % self.capacity
    return nest_utils.tree_map(
        lambda s: s.index_select(0, order).movedim(0, 1), state.storage)
