"""Episodic replay: whole episodes in padded slots on the device.

Port of ``agents_tpu/replay_buffers/episodic_replay.py`` (`init`,
`add_batch` with `return_completed`, `add_sequence`, `_effective_lengths`,
`sample_episodes` with `completed_only` and `return_info`, and
`CompletionCallback`). A fixed pool of episode slots ``[num_slots,
max_episode_len, ...]`` with per-slot lengths; each env row writes into its
open slot; an episode commits when its frame's next step type is LAST, and
the row then opens the next free slot with a fresh, monotone episode id.

Which rows complete is data, so every counter here (slot cursor, next
episode id, completions) is a device tensor, and the calls make no host
sync (scalar fills go through `index_fill_`: an indexed assignment of a
Python number copies it from the host). The JAX package gives each
completing row the next non-busy slot with a scan over rows holding a
while loop (:118-135); the port does the same assignment vectorized: it
rotates the free-slot mask by the cursor, takes its cumsum, and gives
the k-th completing row the k-th free slot by `searchsorted`. Only
`CompletionCallback` reads back to the host, as in the JAX package.

`sample_episodes` draws its slots at site "episode_slot": [S, num_slots]
uniforms in [tiny, 1) turned into Gumbel noise over the valid slots
(``jax.random.categorical``'s sampler, so a test can replay the JAX
package's draws). Unlike the JAX package's eager call it does not check
for an empty buffer, which would need a host read; as under ``jax.jit``,
sampling an empty buffer returns all-zero masks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories.time_step import StepType
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EpisodicReplayState:
  storage: Any                   # [num_slots, max_len, ...]
  lengths: torch.Tensor          # [num_slots] committed lengths (0 = free)
  episode_ids: torch.Tensor      # [num_slots] id of the slot's episode
  next_slot: torch.Tensor        # scalar ring cursor over slots
  next_episode_id: torch.Tensor  # scalar monotone id source
  open_slot: torch.Tensor        # [B] slot each row is writing
  open_len: torch.Tensor         # [B] frames written to the open episode
  num_completed: torch.Tensor    # scalar total completed episodes


class EpisodicReplay:
  """Args:
    data_spec: spec nest for one (unbatched) frame; a Trajectory (its
      `next_step_type` marks episode ends).
    batch_size: env rows B.
    num_slots: episode slots; at least 2B + 1.
    max_episode_len: frames per slot; longer episodes keep writing their
      last frame.
    device: "cuda" unless the caller asks for "cpu".
  """

  def __init__(self, data_spec, batch_size: int, num_slots: int,
               max_episode_len: int, device="cuda"):
    if num_slots < 2 * batch_size + 1:
      # One add_batch can hold B open slots while all B rows complete and
      # each needs a fresh slot: 2B busy, and one more must be free.
      raise ValueError(
          f"num_slots ({num_slots}) must be >= 2*batch_size+1 "
          f"({2 * batch_size + 1}) so fresh-slot assignment always "
          "finds a free slot")
    self.data_spec = data_spec
    self.batch_size = batch_size
    self.num_slots = num_slots
    self.max_episode_len = max_episode_len
    self.device = resolve_device(device)

  def _int(self, value) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.int64, device=self.device)

  def init(self) -> EpisodicReplayState:
    storage = array_spec.zero_spec_nest(
        self.data_spec, outer_dims=(self.num_slots, self.max_episode_len),
        device=self.device)
    B = self.batch_size
    episode_ids = torch.full((self.num_slots,), -1, dtype=torch.int64,
                             device=self.device)
    episode_ids[:B] = torch.arange(B, device=self.device)
    return EpisodicReplayState(
        storage=storage,
        lengths=torch.zeros(self.num_slots, dtype=torch.int64,
                            device=self.device),
        episode_ids=episode_ids,
        next_slot=self._int(B),          # rows 0..B-1 start open
        next_episode_id=self._int(B),
        open_slot=torch.arange(B, device=self.device),
        open_len=torch.zeros(B, dtype=torch.int64, device=self.device),
        num_completed=self._int(0))

  def _free_from(self, cursor: torch.Tensor, busy: torch.Tensor):
    """(offsets, free count up to each offset): offset j is slot
    ``(cursor + j) % num_slots``, and the k-th free slot from the cursor
    (k = 1, 2, ...) is at the first offset whose count reaches k."""
    offsets = torch.arange(self.num_slots, device=self.device)
    rotated = (cursor + offsets) % self.num_slots
    return rotated, torch.cumsum((~busy[rotated]).to(torch.int64), 0)

  def add_batch(self, state: EpisodicReplayState, items,
                return_completed: bool = False):
    """Append one frame per row; commit the episodes whose frame's next
    step type is LAST and give those rows fresh slots.

    With `return_completed=True` also returns the per-row episode ids
    completed by this call (-1 where the row's episode continues)."""
    ns = self.num_slots
    write_t = torch.clamp_max(state.open_len, self.max_episode_len - 1)

    def write_leaf(s, x):
      s[state.open_slot, write_t] = x.to(s.dtype)

    nest_utils.tree_map(write_leaf, state.storage, items)
    new_len = torch.clamp_max(state.open_len + 1, self.max_episode_len)
    done = items.next_step_type == StepType.LAST
    done_int = done.to(torch.int64)

    # Commit: the completed rows' lengths (open slots are distinct).
    lengths = state.lengths.clone()
    lengths[state.open_slot] = torch.where(done, new_len,
                                           lengths[state.open_slot])
    completed = done_int.sum()
    completed_ids = torch.where(done, state.episode_ids[state.open_slot], -1)

    # Fresh slots: the k-th completing row takes the k-th slot from the
    # cursor that is neither open for a row nor just committed (all of
    # them are `open_slot`s here).
    busy = torch.zeros(ns, dtype=torch.bool, device=self.device)
    busy.index_fill_(0, state.open_slot, True)
    rotated, free_count = self._free_from(state.next_slot, busy)
    order = torch.cumsum(done_int, 0) - done_int          # rank among done
    at = torch.clamp_max(torch.searchsorted(free_count, order + 1), ns - 1)
    fresh = torch.where(done, rotated[at], ns)            # ns: no slot
    last = torch.clamp_max(torch.searchsorted(free_count, completed), ns - 1)
    next_slot = torch.where(completed > 0,
                            (state.next_slot + last + 1) % ns,
                            state.next_slot)

    # Newly opened slots are cleared (length 0 marks in progress) and get
    # fresh monotone ids; rows that continue write to a dropped slot `ns`.
    new_ids = state.next_episode_id + order
    lengths = torch.cat([lengths, lengths.new_zeros(1)])
    lengths.index_fill_(0, fresh, 0)
    episode_ids = torch.cat([state.episode_ids,
                             state.episode_ids.new_zeros(1)])
    episode_ids[fresh] = torch.where(done, new_ids, 0)

    new_state = EpisodicReplayState(
        storage=state.storage, lengths=lengths[:ns],
        episode_ids=episode_ids[:ns], next_slot=next_slot,
        next_episode_id=state.next_episode_id + completed,
        open_slot=torch.where(done, fresh, state.open_slot),
        open_len=torch.where(done, 0, new_len),
        num_completed=state.num_completed + completed)
    if return_completed:
      return new_state, completed_ids
    return new_state

  def add_sequence(self, state: EpisodicReplayState, sequence,
                   length=None) -> EpisodicReplayState:
    """Commit one whole episode ``[T, ...]`` in one call into the first
    slot from the cursor that no row holds open. `length` (<= T, a number
    or a device scalar) marks the valid prefix; T by default."""
    T = nest_utils.flatten(sequence)[0].shape[0]
    if T > self.max_episode_len:
      raise ValueError(
          f"sequence length {T} exceeds max_episode_len "
          f"{self.max_episode_len}")
    length = self._int(T if length is None else length)
    busy = torch.zeros(self.num_slots, dtype=torch.bool, device=self.device)
    busy.index_fill_(0, state.open_slot, True)
    rotated, free_count = self._free_from(state.next_slot, busy)
    at = torch.searchsorted(free_count, free_count.new_ones(()))
    slot = rotated[at]

    def write_leaf(s, x):
      row = torch.zeros_like(s[0])
      row[:T] = x.to(s.dtype)
      s.index_copy_(0, slot[None], row[None])

    nest_utils.tree_map(write_leaf, state.storage, sequence)
    lengths = state.lengths.clone()
    lengths.index_copy_(0, slot[None], length[None])
    episode_ids = state.episode_ids.clone()
    episode_ids.index_copy_(0, slot[None], state.next_episode_id[None])
    return dataclasses.replace(
        state, lengths=lengths, episode_ids=episode_ids,
        next_slot=(state.next_slot + at + 1) % self.num_slots,
        next_episode_id=state.next_episode_id + 1,
        num_completed=state.num_completed + 1)

  def _effective_lengths(self, state: EpisodicReplayState,
                         completed_only: bool) -> torch.Tensor:
    """Per-slot sampleable length: committed episodes always, and open
    episodes at their current length unless `completed_only`."""
    if completed_only:
      return state.lengths
    eff = state.lengths.clone()
    eff[state.open_slot] = torch.maximum(state.open_len,
                                         state.lengths[state.open_slot])
    return eff

  def sample_episodes(self, state: EpisodicReplayState, draws,
                      sample_batch_size: int, completed_only: bool = True,
                      return_info: bool = False):
    """Uniformly sample episodes over the valid slots.

    Returns (episodes [S, max_len, ...], mask [S, max_len]); with
    `return_info=True` also a dict of the sampled slots' episode ids,
    lengths and slots."""
    eff = self._effective_lengths(state, completed_only)
    logits = torch.where(eff > 0, 0.0, -1e9)
    tiny = torch.finfo(torch.float32).tiny
    u = draws.uniform("episode_slot", (sample_batch_size, self.num_slots),
                      tiny, 1.0)
    slots = torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)
    eps = nest_utils.tree_map(lambda s: s.index_select(0, slots),
                              state.storage)
    lens = eff.index_select(0, slots)
    mask = (torch.arange(self.max_episode_len, device=self.device)[None, :]
            < lens[:, None]).to(torch.float32)
    if return_info:
      return eps, mask, {"episode_ids": state.episode_ids.index_select(
          0, slots), "lengths": lens, "slots": slots}
    return eps, mask


class CompletionCallback:
  """Host-side bridge for completion callbacks: give it the
  `completed_ids` from ``add_batch(..., return_completed=True)`` and it
  calls each callback once per completed episode id, in id order. The
  read back to the host is this call's one sync."""

  def __init__(self, callbacks: Sequence[Callable[[int], None]]):
    self.callbacks = list(callbacks)

  def __call__(self, completed_ids) -> int:
    ids = torch.as_tensor(completed_ids).reshape(-1).cpu().tolist()
    fired = 0
    for eid in sorted(i for i in ids if i >= 0):
      for cb in self.callbacks:
        cb(eid)
      fired += 1
    return fired
