"""On-device prioritized replay (PER), sampled by inverse CDF.

Port of ``agents_tpu/replay_buffers/prioritized_replay.py`` (`init`,
`clear`, `size`, `add_batch` with optional `priorities`, `add_sequence`,
`sample`, `_gather`, `update_priorities`): Schaul et al.'s proportional
prioritization with stratified sampling. Priorities are a dense
``[capacity, B]`` float32 tensor on the device, and one sample is

  p = where(valid, priority**alpha, 0)      # elementwise
  cdf = chunked cumsum of p.ravel()         # two-level, chunks of 1024
  idx = searchsorted(cdf, stratified_u)     # S binary searches

with new items entering at the running max priority and importance
weights ``(N * P(i))**-beta`` normalized by their max. The JAX package
computes all of this outside any Pallas kernel (XLA lowers the cumsum,
the search and the scatters), and so does the port: `torch.cumsum`,
`torch.searchsorted` and `scatter_reduce_`.

As in the port's `UniformReplay`, the frame count is a host int, so the
ring slot, each position's time id, the validity mask and the number of
valid items come from host arithmetic; `priorities` and `max_priority`
stay on the device, and `sample` and `update_priorities` make no host
sync (no `.item()`, no boolean-mask indexing, no `nonzero`). Storage and
priorities are updated in place: a state returned earlier shares them.

The stratified uniforms come from one draw site, "per_u" of shape [S] in
[0, 1), so a test can replay ``jax.random.uniform(key, (S,))``.

Sequences (R2D2's replay, Kapturowski et al. 2019): with
`sequence_stride` k > 1 a window may start only at the ring slots that
are multiples of k (adjacent sequences of n frames overlap by n - k).
Only those slots get a priority, at insert and by `update_priorities`;
a sample searches the CDF of those slots alone, so no other slot can be
drawn, and the IS weights count the valid starts among them.

Over a data-parallel mesh (`sample_sharded`, `update_priorities_sharded`)
each rank holds its own rows' storage and priorities, samples S/n windows
by inverse CDF over its own priority mass, and max-normalizes the IS
weights globally: one scalar all-reduce (MAX) per sample, and one per
priority update to keep `max_priority` the global maximum on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from agents_tpu_torch.replay_buffers.uniform_replay import (check_min_size,
                                                            check_shardable,
                                                            gather_windows)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device


def chunked_cumsum(flat: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
  """float32 inclusive cumsum with two-level accumulation (the JAX
  package's `_chunked_cumsum`): a cumsum within fixed chunks, offset by a
  cumsum of the chunk totals, which bounds the sequential accumulation at
  O(chunk + N / chunk) additions per element."""
  n = flat.shape[0]
  if n <= chunk:
    return torch.cumsum(flat, 0)
  pad = (-n) % chunk
  chunks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, chunk)
  within = torch.cumsum(chunks, 1)
  offsets = torch.cat([flat.new_zeros(1), torch.cumsum(within[:-1, -1], 0)])
  return (within + offsets[:, None]).reshape(-1)[:n]


@dataclasses.dataclass(frozen=True)
class PrioritizedReplayState:
  storage: Any                 # nest of [capacity, B, ...] tensors
  priorities: torch.Tensor     # [capacity, B] float32, raw (pre-alpha)
  count: int                   # total frames added (host int)
  max_priority: torch.Tensor   # float32 scalar: running max raw priority


class PrioritizedBufferInfo(NamedTuple):
  """Sample metadata: `probabilities` are the P(i) used; `is_weights` the
  normalized (N * P)^-beta weights to pass as `weights=` to agent.train."""
  ids: torch.Tensor            # [S] time ids of the window starts
  rows: torch.Tensor           # [S] env-row ids
  probabilities: torch.Tensor  # [S]
  is_weights: torch.Tensor     # [S]


class PrioritizedReplay:
  """Proportional prioritized ring buffer.

  Args:
    data_spec: spec nest for one (unbatched) frame.
    batch_size: number of parallel env rows B.
    max_length: ring capacity per row.
    alpha: prioritization exponent (0 = uniform).
    epsilon: added to updated priorities so no item starves.
    pack_large_rows: accepted so configs carry over from the JAX package;
      it has no effect here (the [r, 128] packing is a TPU layout).
    debug_min_size_asserts: accepted as in the JAX package; the underfill
      guard (`uniform_replay.check_min_size`) raises at every sample call
      here, with the flag or without it, since the count is a host int.
    sequence_stride: k, the slots a window may start at are the multiples
      of k (1: every slot).
    device: where the storage and priorities live; "cuda" unless the
      caller asks for "cpu".
  """

  def __init__(self, data_spec, batch_size: int, max_length: int,
               alpha: float = 0.6, epsilon: float = 1e-6,
               pack_large_rows: bool = True,
               debug_min_size_asserts: bool = False,
               sequence_stride: int = 1, device="cuda"):
    del pack_large_rows
    if sequence_stride < 1:
      raise ValueError(f"sequence_stride must be >= 1, got {sequence_stride}")
    self.sequence_stride = int(sequence_stride)
    self.debug_min_size_asserts = bool(debug_min_size_asserts)
    self.data_spec = data_spec
    self.batch_size = int(batch_size)
    self.capacity = int(max_length)
    self.alpha = float(alpha)
    self.epsilon = float(epsilon)
    self.device = resolve_device(device)

  # -- lifecycle -------------------------------------------------------------
  def init(self) -> PrioritizedReplayState:
    storage = array_spec.zero_spec_nest(
        self.data_spec, outer_dims=(self.capacity, self.batch_size),
        device=self.device)
    return PrioritizedReplayState(
        storage=storage,
        priorities=torch.zeros((self.capacity, self.batch_size),
                               dtype=torch.float32, device=self.device),
        count=0, max_priority=self._one())

  def _one(self) -> torch.Tensor:
    return torch.ones((), dtype=torch.float32, device=self.device)

  def clear(self, state: PrioritizedReplayState) -> PrioritizedReplayState:
    state.priorities.zero_()
    return dataclasses.replace(state, count=0, max_priority=self._one())

  def size(self, state: PrioritizedReplayState) -> int:
    return min(state.count, self.capacity)

  # -- write -----------------------------------------------------------------
  def add_batch(self, state: PrioritizedReplayState, items,
                priorities: Optional[torch.Tensor] = None
                ) -> PrioritizedReplayState:
    """Write one frame per env row (items [B, ...]) at slot
    ``count % capacity``. New items get the running max priority unless
    `priorities` ([B]) is given."""
    pos = state.count % self.capacity
    nest_utils.tree_map(lambda s, x: s[pos].copy_(x), state.storage, items)
    if pos % self.sequence_stride:
      state.priorities[pos].zero_()     # no window starts here
      return dataclasses.replace(state, count=state.count + 1)
    if priorities is None:
      state.priorities[pos].copy_(state.max_priority.expand(self.batch_size))
      max_p = state.max_priority
    else:
      new_p = priorities.abs().to(torch.float32) + self.epsilon
      state.priorities[pos].copy_(new_p)
      max_p = torch.maximum(state.max_priority, new_p.max())
    return dataclasses.replace(state, count=state.count + 1,
                               max_priority=max_p)

  def add_sequence(self, state: PrioritizedReplayState,
                   items) -> PrioritizedReplayState:
    """Write ``[N, B, ...]`` frames in order, as N `add_batch` calls at
    the running max priority would: only the last `capacity` frames can
    survive a wrap, so only they are written, one indexed copy per
    leaf."""
    n = nest_utils.flatten(items)[0].shape[0]
    keep = min(n, self.capacity)
    start = state.count + n - keep
    slots = (torch.arange(keep, device=self.device) + start) % self.capacity

    def write(s, x):
      s.index_copy_(0, slots, x[n - keep:].to(device=s.device, dtype=s.dtype))

    nest_utils.tree_map(write, state.storage, items)
    starts = (slots % self.sequence_stride == 0)[:, None]
    state.priorities.index_copy_(
        0, slots, torch.where(starts, state.max_priority, 0.0).expand(
            keep, self.batch_size))
    return dataclasses.replace(state, count=state.count + n)

  # -- read ------------------------------------------------------------------
  def _time_ids(self, count: int) -> torch.Tensor:
    """Most recent absolute time id held at each ring position r: the
    largest id < count congruent to r (negative = never written)."""
    r = torch.arange(self.capacity, device=self.device)
    last = count - 1
    return last - torch.remainder(last - r, self.capacity)

  def sample(self, state: PrioritizedReplayState, draws,
             sample_batch_size: int, num_steps: Optional[int] = None,
             beta: float = 0.4, _normalize_is_weights: bool = True):
    """Stratified prioritized sample of windows.

    A window's priority is its first frame's. Returns (batch,
    PrioritizedBufferInfo); leaves are [S, ...] when `num_steps` is None,
    else [S, num_steps, ...]. Draws "per_u" ([S] uniforms) from `draws`.
    `_normalize_is_weights=False` returns the raw ``(N * P(i))**-beta``
    weights, unnormalized by their max.
    """
    batch, info = self._sample(state, draws, sample_batch_size, num_steps,
                               beta)
    if not _normalize_is_weights:
      return batch, info
    return batch, info._replace(
        is_weights=info.is_weights / torch.clamp_min(info.is_weights.max(),
                                                     1e-30))

  def _sample(self, state, draws, sample_batch_size, num_steps, beta):
    """`sample` with the raw IS weights ``(N * P(i))**-beta``."""
    n = 1 if num_steps is None else int(num_steps)
    if n > self.capacity:
      raise ValueError(
          f"sample(num_steps={n}) exceeds ring capacity {self.capacity}: "
          "windows longer than the ring cannot be time-contiguous")
    check_min_size(state.count, n, self.debug_min_size_asserts)
    size = self.size(state)
    t_r = self._time_ids(state.count)                        # [capacity]
    valid = ((t_r >= 0) & (t_r >= state.count - size)
             & (t_r <= state.count - n))                     # [capacity]
    priorities = state.priorities
    if self.sequence_stride > 1:
      # Only the start slots: [P] of them, P = ceil(capacity / stride).
      # Their masses are summed in float64: a float32 sum of ~1e5 of them
      # moves the strata's edges by ~1e-3 of a mass, which picks another
      # sequence for one draw in a few hundred.
      t_r, valid = t_r[::self.sequence_stride], valid[::self.sequence_stride]
      priorities = priorities[::self.sequence_stride].double()
      n_valid = torch.clamp_min(valid.sum() * self.batch_size, 1).double()
    else:
      # Valid start ids are count - size .. count - n: host arithmetic.
      n_valid = float(max((size - n + 1) * self.batch_size, 1))

    ps = torch.where(valid[:, None], torch.pow(priorities, self.alpha),
                     0.0)
    flat = ps.reshape(-1)                                    # [P*B]
    cdf = chunked_cumsum(flat) if flat.dtype == torch.float32 \
        else torch.cumsum(flat, 0)
    total = torch.clamp_min(cdf[-1], 1e-30)

    # Stratified: one uniform per equal-mass stratum (Schaul '15 §B.2.1),
    # clamped strictly below `total` (the JAX package's guard against a
    # last-stratum u == total landing past the last positive mass).
    u = draws.uniform("per_u", (sample_batch_size,)).to(flat.dtype)
    u = (torch.arange(sample_batch_size, dtype=flat.dtype,
                      device=self.device) + u) / sample_batch_size * total
    u = torch.minimum(u, total * (1.0 - 1e-7))
    idx = torch.searchsorted(cdf, u, right=True)
    idx = torch.clamp_max(idx, flat.shape[0] - 1)

    pos = torch.div(idx, self.batch_size, rounding_mode="floor")
    rows = torch.remainder(idx, self.batch_size)
    t0 = t_r.index_select(0, pos)

    probs = flat.index_select(0, idx) / total
    w = torch.where(probs > 0,
                    torch.pow(n_valid * torch.clamp_min(probs, 1e-30),
                              -float(beta)), 0.0)
    probs, w = probs.float(), w.float()

    batch = self._gather(state.storage, t0, rows, n)
    if num_steps is None:
      batch = nest_utils.tree_map(lambda x: x[:, 0], batch)
    return batch, PrioritizedBufferInfo(ids=t0, rows=rows,
                                        probabilities=probs, is_weights=w)

  def local(self, num_shards: int) -> "PrioritizedReplay":
    """The replay of one of `num_shards` equal shares of the env rows."""
    check_shardable(self.batch_size, None, num_shards)
    return PrioritizedReplay(self.data_spec, self.batch_size // num_shards,
                             self.capacity, alpha=self.alpha,
                             epsilon=self.epsilon,
                             debug_min_size_asserts=(
                                 self.debug_min_size_asserts),
                             sequence_stride=self.sequence_stride,
                             device=self.device)

  def sample_sharded(self, state: PrioritizedReplayState, draws,
                     sample_batch_size: int, mesh,
                     num_steps: Optional[int] = None, beta: float = 0.4):
    """This rank's share of a prioritized sample over a row-sharded buffer
    (the JAX package's `sample_sharded`, :214-275).

    `state` holds this rank's rows. The rank inverse-CDF samples S/n
    windows from its own priority mass (shards are equal-mass strata:
    probabilities divided by n), so no storage crosses ranks. The raw IS
    weight ``(N_local * P_local)**-beta`` equals the global one under that
    convention; the weights are normalized by their global max, the one
    scalar all-reduce. Row ids come back global (offset by ``rank *
    B/n``).
    """
    n = mesh.size
    check_shardable(self.batch_size, sample_batch_size, n)
    batch, info = self.local(n)._sample(state, draws, sample_batch_size // n,
                                        num_steps, beta)
    gmax = mesh.all_reduce(info.is_weights.max(), "max")
    return batch, PrioritizedBufferInfo(
        ids=info.ids, rows=info.rows + mesh.rank * (self.batch_size // n),
        probabilities=info.probabilities / n,
        is_weights=info.is_weights / torch.clamp_min(gmax, 1e-30))

  def _gather(self, storage, t0, rows, n):
    return gather_windows(storage, t0, rows, n, self.capacity,
                          self.batch_size)

  # -- priority maintenance ----------------------------------------------------
  def update_priorities(self, state: PrioritizedReplayState,
                        info: PrioritizedBufferInfo,
                        td_errors: torch.Tensor) -> PrioritizedReplayState:
    """Scatter |td_error| + eps back to the sampled items. Stale ids
    (overwritten since sampling) are dropped; among duplicate ids of one
    call the largest new priority wins, deterministically: a scatter-min
    to zero of the live slots, then a scatter-max of the new values, on
    the flat index ``pos * B + row``."""
    new_p = td_errors.abs().to(torch.float32) + self.epsilon
    pos = torch.remainder(info.ids, self.capacity)
    live = (info.ids >= 0) & (info.ids >= state.count - self.size(state))
    flat_idx = pos * self.batch_size + info.rows
    flat = state.priorities.view(-1)
    cur = flat.index_select(0, flat_idx)
    # Stale updates give their current value to the min and 0 to the max,
    # so they neither resurrect nor clobber anything.
    flat.scatter_reduce_(0, flat_idx, torch.where(live, 0.0, cur), "amin",
                         include_self=True)
    live_p = torch.where(live, new_p, 0.0)
    flat.scatter_reduce_(0, flat_idx, live_p, "amax", include_self=True)
    return dataclasses.replace(
        state, max_priority=torch.maximum(state.max_priority, live_p.max()))

  def update_priorities_sharded(self, state: PrioritizedReplayState,
                                info: PrioritizedBufferInfo,
                                td_errors: torch.Tensor, mesh
                                ) -> PrioritizedReplayState:
    """`update_priorities` of this rank's rows from `sample_sharded`'s
    info (global row ids); `max_priority` becomes the global maximum on
    every rank (one scalar all-reduce), as the JAX package keeps it
    replicated."""
    n = mesh.size
    local_info = info._replace(
        rows=info.rows - mesh.rank * (self.batch_size // n))
    state = self.local(n).update_priorities(state, local_info, td_errors)
    return dataclasses.replace(
        state, max_priority=mesh.all_reduce(state.max_priority.clone(), "max"))
