"""Offline trajectory datasets on disk, and their way back into a replay.

Port of ``agents_tpu/utils/dataset_io.py``: `TrajectoryFileObserver`
shards trajectory frames to ``shard_{i:05d}.npz`` files beside a
``spec.json`` manifest, `load_trajectory_dataset` yields the shards back
as nests, `dataset_num_frames` counts frames from the npy headers alone,
and `dataset_to_replay` streams a dataset into a `UniformReplay` with
`add_sequence`.

The files are the JAX package's, byte for byte in layout, so a dataset
written by either side loads into the other: each shard holds ``leaf_{i}``
arrays, the leaves in ``jax.tree_util``'s flatten order (dataclass fields
in order, dict keys sorted, None and () empty), and ``spec.json`` lists
the leaf specs in that order as ``policy_saver._spec_to_json`` writes
them. The port's own nests keep dict keys in insertion order, so this
module flattens and rebuilds with sorted keys itself.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import zipfile
from typing import Any, Iterator, List

import numpy as np
import torch

from agents_tpu_torch.specs import array_spec


def _leaves(tree) -> List[Any]:
  """`tree`'s leaves in ``jax.tree_util``'s order."""
  if tree is None:
    return []
  if isinstance(tree, dict):
    return [x for k in sorted(tree) for x in _leaves(tree[k])]
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    return [x for f in dataclasses.fields(tree)
            if not f.metadata.get("static") for x in _leaves(getattr(tree,
                                                                    f.name))]
  if isinstance(tree, (tuple, list)):
    return [x for child in tree for x in _leaves(child)]
  return [tree]


def _rebuild(template, leaves: Iterator):
  """`template`'s structure with its leaves taken from `leaves` in
  ``jax.tree_util``'s order."""
  if template is None:
    return None
  if isinstance(template, dict):
    built = {k: _rebuild(template[k], leaves) for k in sorted(template)}
    return {k: built[k] for k in template}
  if dataclasses.is_dataclass(template) and not isinstance(template, type):
    return type(template)(**{
        f.name: getattr(template, f.name) if f.metadata.get("static")
        else _rebuild(getattr(template, f.name), leaves)
        for f in dataclasses.fields(template)})
  if isinstance(template, (tuple, list)):
    children = [_rebuild(child, leaves) for child in template]
    if hasattr(template, "_fields"):
      return type(template)(*children)
    return type(template)(children)
  return next(leaves)


def _spec_to_json(spec) -> dict:
  """One spec as ``agents_tpu/policies/policy_saver.py:_spec_to_json``
  writes it."""
  d = {"shape": list(spec.shape), "dtype": np.dtype(spec.dtype).name,
       "name": spec.name}
  if isinstance(spec, array_spec.BoundedArraySpec):
    d["minimum"] = np.asarray(spec.minimum).tolist()
    d["maximum"] = np.asarray(spec.maximum).tolist()
  return d


def _numpy(x) -> np.ndarray:
  if isinstance(x, torch.Tensor):
    return x.detach().cpu().numpy()
  return np.asarray(x)


class TrajectoryFileObserver:
  """Collects frames (nests of tensors or arrays) and writes a shard every
  `frames_per_shard` of them; `flush` writes the rest."""

  def __init__(self, path: str, data_spec, frames_per_shard: int = 4096):
    self.path = os.path.abspath(path)
    os.makedirs(self.path, exist_ok=True)
    self.data_spec = data_spec
    self.frames_per_shard = frames_per_shard
    self._buffer = []
    self._shard = 0
    specs = [s for s in _leaves(data_spec) if isinstance(s,
                                                          array_spec.ArraySpec)]
    with open(os.path.join(self.path, "spec.json"), "w") as f:
      json.dump([_spec_to_json(s) for s in specs], f)

  def __call__(self, traj):
    self._buffer.append([_numpy(x) for x in _leaves(traj)])
    if len(self._buffer) >= self.frames_per_shard:
      self.flush()

  def flush(self):
    if not self._buffer:
      return
    leaves = [np.stack(xs) for xs in zip(*self._buffer)]
    np.savez_compressed(
        os.path.join(self.path, f"shard_{self._shard:05d}.npz"),
        **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
    self._shard += 1
    self._buffer = []


def _shards(path: str):
  return sorted(glob.glob(os.path.join(path, "shard_*.npz")))


def load_trajectory_dataset(path: str, template) -> Iterator[Any]:
  """Yields each shard as a nest of numpy arrays with `template`'s
  structure (a frame, a spec nest or any nest of the same shape)."""
  for shard in _shards(path):
    with np.load(shard) as data:
      leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    yield _rebuild(template, iter(leaves))


def dataset_num_frames(path: str) -> int:
  """Frames per replay row across all shards, read from the npy header of
  each shard's first leaf without decompressing the arrays. Size a replay
  ring from this, not from a config: a ring shorter than the dataset
  wraps and drops the oldest frames."""
  total = 0
  for shard in _shards(path):
    with zipfile.ZipFile(shard) as zf, zf.open("leaf_0.npy") as f:
      version = np.lib.format.read_magic(f)
      if version == (1, 0):
        shape, _, _ = np.lib.format.read_array_header_1_0(f)
      else:
        shape, _, _ = np.lib.format.read_array_header_2_0(f)
    total += int(shape[0])
  return total


def dataset_to_replay(path: str, template, replay, replay_state):
  """Stream a dataset into `replay` (its storage on its device), shard by
  shard through `add_sequence`. A shard's frames are ``[N, B, ...]``, or
  ``[N, ...]`` broadcast to the replay's B rows; which of the two is read
  from the replay's per-frame spec rank."""
  frame_rank = len(_leaves(replay.data_spec)[0].shape)
  for shard in load_trajectory_dataset(path, template):
    leaves = _leaves(shard)
    n = leaves[0].shape[0]
    lead = leaves[0].ndim - frame_rank
    if lead == 2:
      if leaves[0].shape[1] != replay.batch_size:
        raise ValueError(
            f"dataset batch size {leaves[0].shape[1]} != replay batch_size "
            f"{replay.batch_size}; re-record or rebuild the replay with "
            "matching rows")
      expand = lambda x: x  # noqa: E731
    elif lead == 1:
      expand = lambda x: np.broadcast_to(  # noqa: E731
          x[:, None], (n, replay.batch_size) + x.shape[1:])
    else:
      raise ValueError(
          f"shard leading rank {lead} unsupported (expected [N, ...] or "
          "[N, B, ...])")
    frames = _rebuild(shard, iter(
        torch.from_numpy(np.ascontiguousarray(expand(x))).to(replay.device)
        for x in leaves))
    replay_state = replay.add_sequence(replay_state, frames)
  return replay_state
