"""The data-parallel group and its placement rules.

Port of ``agents_tpu/parallel/mesh_utils.py`` (`create_mesh`,
`replicated`, `batch_sharded`, `shard_loop_state`) over
`torch.distributed`. The JAX package builds a 1-D device mesh, annotates
the env-row axis of the loop state ``P('data')`` and keeps parameters
replicated; the SPMD partitioner then inserts the gradient all-reduces.
Here each process holds its own rows, so the names take a torch meaning:

* `create_mesh` returns a `Mesh` over the default process group: its
  size n, this rank, the device, and the group's collectives (`all_reduce`,
  `all_gather_rows`, `broadcast`), each counting the bytes it passes to
  `torch.distributed` in `bytes_passed`. Without a process group the mesh
  is one rank and its collectives are the identity.
* `replicated` and `batch_sharded` are placement rules: callables from a
  global tensor to this rank's tensor (rank 0's copy, or this rank's
  ``1/n`` of the rows on an axis).
* `shard_loop_state` cuts a `LoopState` or `OnPolicyLoopState` built for
  the global batch B to this rank's B/n rows.

What GSPMD reduces implicitly, the port reduces explicitly: the loops
built with a mesh (`FusedTrainLoop(mesh=)`, `OnPolicyTrainLoop(mesh=)`)
average gradients in `agents.agent.apply_gradients`, report the mean of
the ranks' scalar losses, and feed the replicated metric deques from
every rank's rows; PPO reduces its whole-rollout statistics with sums.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


class Mesh:
  """A 1-D data-parallel group of `size` ranks (one process each).

  Collectives take tensors on the mesh's device as they are: NCCL on a
  card, and gloo too (its collectives take CUDA tensors and stage them
  through host memory themselves; PERF.md). `bytes_passed` counts the
  bytes of every tensor handed to a collective since the last
  `reset_bytes`, and `largest_numel` the largest such tensor per
  collective kind.
  """

  def __init__(self, size: int, rank: int, device,
               axis_name: str = "data"):
    self.size = int(size)
    self.rank = int(rank)
    self.device = torch.device(device)
    self.axis_name = axis_name
    self.distributed = dist.is_available() and dist.is_initialized()
    self.reset_bytes()

  def reset_bytes(self):
    self.bytes_passed = 0
    self.calls = 0
    self.largest_numel = {}

  def _count(self, kind: str, tensor: torch.Tensor):
    self.bytes_passed += tensor.numel() * tensor.element_size()
    self.calls += 1
    self.largest_numel[kind] = max(self.largest_numel.get(kind, 0),
                                   tensor.numel())

  def all_reduce(self, tensor: torch.Tensor, op: str = "sum"):
    """Reduce `tensor` over the group in place ("sum", "max" or "min");
    returns it."""
    if not self.distributed:
      return tensor
    self._count("all_reduce", tensor)
    dist.all_reduce(tensor, op=_REDUCE_OPS[op])
    return tensor

  def all_gather_rows(self, tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's `tensor` concatenated along dim 0, in rank order."""
    if not self.distributed:
      return tensor
    self._count("all_gather", tensor)
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor) for _ in range(self.size)]
    dist.all_gather(parts, tensor)
    return torch.cat(parts)

  def broadcast(self, tensor: torch.Tensor, src: int = 0):
    """Rank `src`'s `tensor` into every rank's, in place; returns it."""
    if not self.distributed:
      return tensor
    self._count("broadcast", tensor)
    dist.broadcast(tensor, src=src)
    return tensor

  def mean_scalars(self, nest):
    """`nest` with every 0-dim floating tensor replaced by its mean over
    the ranks (one all-reduce); other leaves as they are."""
    leaves = nest_utils.flatten(nest)
    idx = [i for i, x in enumerate(leaves)
           if isinstance(x, torch.Tensor) and x.dim() == 0
           and x.is_floating_point()]
    if not self.distributed or not idx:
      return nest
    packed = torch.stack([leaves[i].float() for i in idx])
    self.all_reduce(packed).div_(self.size)
    for j, i in enumerate(idx):
      leaves[i] = packed[j].to(leaves[i].dtype)
    it = iter(leaves)
    return nest_utils.tree_map(lambda _: next(it), nest)


def create_mesh(num_devices: Optional[int] = None, axis_name: str = "data",
                device="cuda") -> Mesh:
  """The 1-D data-parallel group over the default process group of an
  initialized `torch.distributed`; without one, a mesh of one rank.
  `num_devices`, when given, must be the group's size."""
  device = resolve_device(device)
  if dist.is_available() and dist.is_initialized():
    size, rank = dist.get_world_size(), dist.get_rank()
  else:
    size, rank = 1, 0
  if num_devices is not None and num_devices != size:
    raise ValueError(f"asked for a mesh of {num_devices}, the process group "
                     f"has {size} ranks")
  return Mesh(size, rank, device, axis_name)


@dataclasses.dataclass(frozen=True)
class _Replicated:
  mesh: Mesh

  def __call__(self, x):
    """Rank 0's copy of `x` (broadcast in place)."""
    if isinstance(x, torch.Tensor) and x.device.type == self.mesh.device.type:
      self.mesh.broadcast(x.data)
    return x


@dataclasses.dataclass(frozen=True)
class _BatchSharded:
  mesh: Mesh
  batch_axis: int

  def __call__(self, x):
    """This rank's ``1/n`` of `x`'s rows on `batch_axis` (a copy)."""
    rows = x.shape[self.batch_axis]
    if rows % self.mesh.size:
      raise ValueError(f"{rows} rows do not split over {self.mesh.size} "
                       "ranks")
    local = rows // self.mesh.size
    return x.narrow(self.batch_axis, self.mesh.rank * local,
                    local).clone(memory_format=torch.contiguous_format)


def replicated(mesh: Mesh) -> _Replicated:
  return _Replicated(mesh)


def batch_sharded(mesh: Mesh, batch_axis: int = 0) -> _BatchSharded:
  return _BatchSharded(mesh, batch_axis)


def _replicate_agent_state(agent_state, rep: _Replicated):
  """Broadcast every tensor of an agent state from rank 0 in place:
  networks' parameters and buffers, optimizer state on the mesh's device
  (torch's Adam keeps its step counts on the host, equal on every rank),
  and tensor nests."""
  for field in dataclasses.fields(agent_state):
    value = getattr(agent_state, field.name)
    if isinstance(value, torch.nn.Module):
      for t in list(value.parameters()) + list(value.buffers()):
        rep(t)
    elif isinstance(value, torch.optim.Optimizer):
      for per_param in value.state.values():
        for t in per_param.values():
          rep(t)
    elif isinstance(value, torch.Tensor) or dataclasses.is_dataclass(value):
      for t in nest_utils.flatten(value):
        rep(t)


def _shard_metric_states(metric_states, rows: _BatchSharded,
                         rep: _Replicated):
  """Each metric's per-row `accumulator` is cut; its deques and counters
  stay replicated (the loops feed them from every rank's rows)."""

  def one(state):
    if dataclasses.is_dataclass(state):
      return dataclasses.replace(state, **{
          f.name: (rows(getattr(state, f.name)) if f.name == "accumulator"
                   else one(getattr(state, f.name)))
          for f in dataclasses.fields(state)})
    if isinstance(state, (tuple, list)):
      return type(state)(one(s) for s in state)
    if isinstance(state, torch.Tensor):
      return rep(state)
    return state

  return tuple(one(s) for s in metric_states)


def shard_loop_state(loop_state, mesh: Mesh, batch_size: int,
                     replay_capacity: Optional[int] = None, draws=None):
  """This rank's part of a loop state built for the global batch.

  Placement keys on the state's field first and on shape second, so a
  dim that happens to equal `batch_size` (replay capacity, a weight
  matrix) is never cut by mistake:
    - `driver_state`: leaves with leading dim `batch_size` -> this rank's
      rows; anything else replicated;
    - `replay_state`: storage (and PER priorities) ``[capacity, B, ...]``
      -> this rank's rows on axis 1; the count is a host int; the max
      priority replicated;
    - `agent_state`: replicated (broadcast from rank 0);
    - `metric_states`: per-row accumulators cut, deques and counters
      replicated;
    - `draws`: replaced by `draws`, this rank's draw source (required
      with more than one rank: each rank draws for its own rows).
  Every replicated tensor is broadcast from rank 0, so the ranks start
  bit-equal.
  """
  if mesh.size > 1 and draws is None:
    raise ValueError("shard_loop_state needs this rank's draw source "
                     "(`draws`) when the mesh has more than one rank")
  rep, rows0, rows1 = (replicated(mesh), batch_sharded(mesh, 0),
                       batch_sharded(mesh, 1))
  if batch_size % mesh.size:
    raise ValueError(f"batch_size {batch_size} not divisible by the "
                     f"'{mesh.axis_name}' axis size {mesh.size}")

  def driver_leaf(x):
    if isinstance(x, torch.Tensor):
      if x.dim() >= 1 and x.shape[0] == batch_size:
        return rows0(x)
      return rep(x)
    return x

  updates = {"driver_state": nest_utils.tree_map(driver_leaf,
                                                 loop_state.driver_state)}
  replay = getattr(loop_state, "replay_state", None)
  if replay is not None:
    def storage_leaf(x):
      if replay_capacity is not None and x.shape[0] != replay_capacity:
        raise ValueError(f"replay leaf of shape {tuple(x.shape)} does not "
                         f"hold capacity {replay_capacity}")
      return rows1(x)

    fields = {"storage": nest_utils.tree_map(storage_leaf, replay.storage)}
    if hasattr(replay, "priorities"):
      fields["priorities"] = storage_leaf(replay.priorities)
      fields["max_priority"] = rep(replay.max_priority)
    updates["replay_state"] = dataclasses.replace(replay, **fields)
  _replicate_agent_state(loop_state.agent_state, rep)
  updates["metric_states"] = _shard_metric_states(
      loop_state.metric_states, rows0, rep)
  if draws is not None:
    updates["draws"] = draws
  return dataclasses.replace(loop_state, **updates)
