"""Composite (sparse / ragged) array utilities.

Port of ``agents_tpu/utils/composite.py`` (the reference's
``tf_agents/utils/composite.py``: shape / reshape / squeeze / expand_dims /
slice_from / slice_to over dense-or-SparseTensor, plus the RaggedTensor
handling of its nest utilities), on tensors.

The JAX package keeps every shape static, so the port keeps its layouts:

* ``SparseArray`` — COO with a fixed nonzero capacity: ``indices``
  [capacity, ndim] int64, ``values`` [capacity], ``valid`` [capacity]
  bool, and a static ``dense_shape``. `from_dense` raises when the
  nonzeros exceed the capacity. All ops are fixed-shape masked math, so no
  op reads a count back from the device.
* ``RaggedArray`` — padded ``values`` [B, L_max, ...] + ``lengths`` [B]
  int32; ops maintain the lengths.

The six generic ops accept plain tensors too, like the reference's
transparent dispatch. Indices are int64 (torch's index type) where the
JAX package keeps int32.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SparseArray:
  """Fixed-capacity COO sparse array."""
  indices: torch.Tensor          # [capacity, ndim] int64
  values: torch.Tensor           # [capacity, ...]
  valid: torch.Tensor            # [capacity] bool
  dense_shape: Tuple[int, ...] = nest_utils.static_field()

  @property
  def capacity(self) -> int:
    return self.indices.shape[0]

  def nnz(self) -> torch.Tensor:
    return self.valid.sum()

  @classmethod
  def from_dense(cls, x: torch.Tensor, capacity: int) -> "SparseArray":
    """The first `capacity` nonzeros of `x` in row-major order; raises
    when `x` has more. As in the JAX package, the capacity is at most
    `x`'s size."""
    flat = x.reshape(-1)
    nz = flat != 0
    n = int(nz.sum())
    if n > capacity:
      raise ValueError(f"{n} nonzeros exceed capacity {capacity}")
    size = flat.shape[0]
    positions = torch.arange(size, device=x.device)
    # Stable order: nonzeros first, by flat position.
    order = torch.argsort(torch.where(nz, positions, size),
                          stable=True)[:capacity]
    valid = nz[order]
    flat_idx = torch.where(valid, order, 0)
    idx = torch.stack(torch.unravel_index(flat_idx, tuple(x.shape)), -1)
    vals = torch.where(valid, flat[flat_idx], 0)
    return cls(indices=idx.to(torch.int64), values=vals, valid=valid,
               dense_shape=tuple(int(d) for d in x.shape))

  def to_dense(self) -> torch.Tensor:
    out = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                      device=self.values.device)
    vals = torch.where(self.valid, self.values, 0)
    # Invalid slots add 0 at position 0: harmless by construction.
    return out.index_put(tuple(self.indices.t()), vals, accumulate=True)


@dataclasses.dataclass(frozen=True)
class RaggedArray:
  """Padded ragged batch: values [B, L_max, ...] + lengths [B]."""
  values: torch.Tensor
  lengths: torch.Tensor          # [B] int32

  @classmethod
  def from_rows(cls, rows, l_max: int = None,
                device="cuda") -> "RaggedArray":
    """Build from a python list of [l_i, ...] arrays (host-side), on
    `device` ("cuda" unless the caller asks for "cpu")."""
    device = resolve_device(device)
    lengths = np.array([r.shape[0] for r in rows], np.int32)
    l_max = int(l_max or lengths.max(initial=0))
    tail = rows[0].shape[1:] if rows else ()
    out = np.zeros((len(rows), l_max) + tuple(tail),
                   rows[0].dtype if rows else np.float32)
    for i, r in enumerate(rows):
      out[i, :r.shape[0]] = r
    return cls(values=torch.as_tensor(out, device=device),
               lengths=torch.as_tensor(lengths, device=device))

  def mask(self) -> torch.Tensor:
    """[B, L_max] bool validity mask."""
    steps = torch.arange(self.values.shape[1], device=self.values.device)
    return steps[None, :] < self.lengths[:, None]

  def row_splits(self) -> torch.Tensor:
    """tf.RaggedTensor-style row_splits [B+1]."""
    return torch.cat([self.lengths.new_zeros(1),
                      torch.cumsum(self.lengths, 0).to(self.lengths.dtype)])


# -- generic ops (reference composite.py surface) ---------------------------

def _device(t):
  return t.values.device if isinstance(t, (SparseArray, RaggedArray)) \
      else t.device


def shape(t):
  """reference :25 — dense_shape for sparse, shape otherwise."""
  if isinstance(t, SparseArray):
    dims = t.dense_shape
  elif isinstance(t, RaggedArray):
    dims = tuple(t.values.shape)
  else:
    dims = tuple(t.shape)
  return torch.tensor(dims, dtype=torch.int64, device=_device(t))


def _resolve_shape(new_shape, old_size: int) -> Tuple[int, ...]:
  dims = [int(d) for d in new_shape]
  if dims.count(-1) > 1:
    raise ValueError("at most one -1 dim")
  if -1 in dims:
    rest = int(np.prod([d for d in dims if d != -1]))
    dims[dims.index(-1)] = old_size // max(rest, 1)
  return tuple(dims)


def _flat_indices(t: SparseArray) -> torch.Tensor:
  strides = np.concatenate(
      [np.cumprod(np.asarray(t.dense_shape[1:], np.int64)[::-1])[::-1],
       [1]]).astype(np.int64)
  return (t.indices * torch.as_tensor(strides, device=t.indices.device)
          ).sum(-1)


def reshape(t, new_shape):
  """reference :32 — index-space reshape for SparseArray."""
  if isinstance(t, SparseArray):
    dims = _resolve_shape(new_shape, int(np.prod(t.dense_shape)))
    if int(np.prod(dims)) != int(np.prod(t.dense_shape)):
      raise ValueError(f"cannot reshape {t.dense_shape} to {dims}")
    idx = torch.stack(torch.unravel_index(_flat_indices(t), dims), -1)
    return SparseArray(indices=idx.to(torch.int64), values=t.values,
                       valid=t.valid, dense_shape=dims)
  return torch.reshape(t, tuple(int(d) for d in new_shape))


def squeeze(t, axis: int):
  """reference :49 — drop a size-1 dim."""
  if isinstance(t, SparseArray):
    axis = axis % len(t.dense_shape)
    if t.dense_shape[axis] != 1:
      raise ValueError(f"dim {axis} is {t.dense_shape[axis]}, not 1")
    keep = [i for i in range(len(t.dense_shape)) if i != axis]
    return SparseArray(indices=t.indices[:, keep], values=t.values,
                       valid=t.valid,
                       dense_shape=tuple(t.dense_shape[i] for i in keep))
  return torch.squeeze(t, dim=axis)


def expand_dims(t, axis: int):
  """reference :94."""
  if isinstance(t, SparseArray):
    nd = len(t.dense_shape)
    axis = axis % (nd + 1)
    zeros = t.indices.new_zeros((t.capacity, 1))
    idx = torch.cat([t.indices[:, :axis], zeros, t.indices[:, axis:]], dim=1)
    new_shape = t.dense_shape[:axis] + (1,) + t.dense_shape[axis:]
    return SparseArray(indices=idx, values=t.values, valid=t.valid,
                       dense_shape=new_shape)
  return torch.unsqueeze(t, axis)


def _dense_slice(t, axis, start, end):
  idx = [slice(None)] * t.dim()
  idx[axis] = slice(start, end)
  return t[tuple(idx)]


def slice_from(t, axis: int, start: int):
  """reference :130 — t[..., start:, ...] along `axis`. Negative start
  counts from the end. Sparse keeps its capacity; out-of-range entries
  are invalidated and indices shifted."""
  if isinstance(t, SparseArray):
    axis = axis % len(t.dense_shape)
    size = t.dense_shape[axis]
    start = start % size if start < 0 else start
    keep = t.valid & (t.indices[:, axis] >= start)
    idx = t.indices.clone()
    idx[:, axis] -= torch.where(keep, start, 0)
    idx = torch.where(keep[:, None], idx, 0)
    new_shape = (t.dense_shape[:axis] + (size - start,)
                 + t.dense_shape[axis + 1:])
    return SparseArray(indices=idx,
                       values=torch.where(keep, t.values, 0),
                       valid=keep, dense_shape=new_shape)
  if isinstance(t, RaggedArray):
    if axis != 1:
      raise ValueError("RaggedArray slicing is along the ragged axis (1)")
    return RaggedArray(values=t.values[:, start:],
                       lengths=torch.clamp(t.lengths - start, min=0))
  return _dense_slice(t, axis, start, None)


def slice_to(t, axis: int, end: int):
  """reference :179 — t[..., :end, ...] along `axis`."""
  if isinstance(t, SparseArray):
    axis = axis % len(t.dense_shape)
    size = t.dense_shape[axis]
    end = end % size if end < 0 else end
    keep = t.valid & (t.indices[:, axis] < end)
    idx = torch.where(keep[:, None], t.indices, 0)
    new_shape = t.dense_shape[:axis] + (end,) + t.dense_shape[axis + 1:]
    return SparseArray(indices=idx, values=torch.where(keep, t.values, 0),
                       valid=keep, dense_shape=new_shape)
  if isinstance(t, RaggedArray):
    if axis != 1:
      raise ValueError("RaggedArray slicing is along the ragged axis (1)")
    return RaggedArray(values=t.values[:, :end],
                       lengths=torch.clamp(t.lengths, max=end))
  return _dense_slice(t, axis, None, end)
