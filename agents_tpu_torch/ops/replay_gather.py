"""Replay-sample row gather and the packed row layout.

Port of ``agents_tpu/ops/replay_gather.py``: `gather_rows`, and the
packed layout's helpers `packed_row_shape`, `should_pack`, `pack_rows`,
`unpack_rows` and `RowPacker`, with the JAX shapes (a row of F elements
as a zero-padded ``[r, 128]`` block, r a multiple of the dtype's sublane
count; rows of at least 4096 bytes packed).

The port's replay buffers keep every row in its natural shape and do not
use the packed layout, for two reasons. The ``[r, 128]`` block exists for
the TPU's (8, 128) tiling of the two minor dims, which a row gather on
the card does not have. And what a sample returns, the observable
contract, is equal either way: `RowPacker.from_stored` gives back the
natural rows. So `pack_large_rows=True` on a buffer changes nothing, and
these helpers serve code that wants the layout itself.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device

_LANES = 128
_SUBLANE = {1: 32, 2: 16, 4: 8, 8: 4}

# Rows below this byte count stay natural in the JAX package's layout.
_MIN_ROW_BYTES = 4096


def packed_row_shape(f: int, dtype) -> tuple:
  """Tile-aligned 2D shape ``(r, 128)`` holding a row of f elements."""
  sub = _SUBLANE[array_spec.numpy_dtype(dtype).itemsize]
  r = -(-f // _LANES)
  r = -(-r // sub) * sub
  return (r, _LANES)


def should_pack(row_shape: tuple, dtype) -> bool:
  """Whether a leaf with this per-frame shape is stored packed: rows of
  at least `_MIN_ROW_BYTES` bytes (Atari frames), not classic-control
  vectors."""
  row_bytes = math.prod(row_shape) * array_spec.numpy_dtype(dtype).itemsize
  return row_bytes >= _MIN_ROW_BYTES


def pack_rows(x: torch.Tensor) -> torch.Tensor:
  """``[..., F] -> [..., r, 128]``, zero-padded. Flatten a frame's
  feature dims first."""
  f = x.shape[-1]
  r, lanes = packed_row_shape(f, x.dtype)
  flat = torch.nn.functional.pad(x, (0, r * lanes - f))
  return flat.reshape(tuple(x.shape[:-1]) + (r, lanes))


def unpack_rows(p: torch.Tensor, f: int) -> torch.Tensor:
  """``[..., r, 128] -> [..., F]``."""
  flat = p.reshape(tuple(p.shape[:-2]) + (p.shape[-2] * p.shape[-1],))
  return flat[..., :f]


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
  """table: [N, ...row]; indices: [S] int64 -> [S, ...row]."""
  return table.index_select(0, indices)


class RowPacker:
  """Per-leaf packed-storage policy for a replay ``data_spec``.

  Leaves whose per-frame payload is at least `_MIN_ROW_BYTES` are stored
  as ``[r, 128]`` blocks; smaller leaves keep their natural shape. Leaves
  are in ``jax.tree_util``'s order (dict keys sorted), as the JAX
  packer's `flatten` gives them. `init_storage` allocates on `device`,
  "cuda" unless the caller asks for "cpu".
  """

  def __init__(self, data_spec, enabled: bool = True, device="cuda"):
    self.data_spec = data_spec
    self.device = resolve_device(device)
    leaves = nest_utils.flatten_sorted(data_spec,
                                       is_leaf=array_spec._is_spec)
    self.feat_shapes = [tuple(int(d) for d in s.shape) for s in leaves]
    self.dtypes = [np.dtype(s.dtype) for s in leaves]
    self.packed = [bool(enabled) and should_pack(s.shape, s.dtype)
                   for s in leaves]
    self.any_packed = any(self.packed)

  def flatten(self, tree):
    return nest_utils.flatten_sorted(tree)

  def unflatten(self, leaves):
    return nest_utils.unflatten_sorted(self.data_spec, leaves,
                                       is_leaf=array_spec._is_spec)

  def stored_shape(self, i: int) -> tuple:
    """Per-frame shape of leaf i as stored (packed block or natural)."""
    feat = self.feat_shapes[i]
    if not self.packed[i]:
      return feat
    return packed_row_shape(math.prod(feat), self.dtypes[i])

  def init_storage(self, outer_dims: tuple):
    """Zero storage nest with leaves ``[*outer_dims, *stored]``."""
    return self.unflatten([
        torch.zeros(tuple(outer_dims) + self.stored_shape(i),
                    dtype=array_spec.torch_dtype(self.dtypes[i]),
                    device=self.device)
        for i in range(len(self.feat_shapes))])

  def to_stored(self, items, outer_ndim: int):
    """Frames ``[*outer, *feat]`` -> storage ``[*outer, *stored]``."""
    if not self.any_packed:
      return items
    out = []
    for i, x in enumerate(self.flatten(items)):
      if self.packed[i]:
        outer = tuple(x.shape[:outer_ndim])
        x = pack_rows(x.reshape(outer + (math.prod(self.feat_shapes[i]),)))
      out.append(x)
    return self.unflatten(out)

  def from_stored(self, items, outer_ndim: int):
    """Storage ``[*outer, *stored]`` -> frames ``[*outer, *feat]``."""
    if not self.any_packed:
      return items
    out = []
    for i, x in enumerate(self.flatten(items)):
      if self.packed[i]:
        outer = tuple(x.shape[:outer_ndim])
        feat = self.feat_shapes[i]
        x = unpack_rows(x, math.prod(feat)).reshape(outer + feat)
      out.append(x)
    return self.unflatten(out)
