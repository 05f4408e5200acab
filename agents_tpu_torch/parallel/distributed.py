"""Multi-process initialization and distributed helpers.

Port of ``agents_tpu/parallel/distributed.py`` over `torch.distributed`.
The JAX package's `initialize` wraps ``jax.distributed.initialize``; here
it joins a `torch.distributed` process group, after which
`parallel.create_mesh` spans every process and the loops built with that
mesh run data-parallel (each process steps its own env rows, the analogue
of N Actor jobs; gradients are averaged by `agents.agent.apply_gradients`).

Nothing on a card's machine announces a cluster, so `initialize` reads the
JAX package's variables, ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and
``PROCESS_ID``, or takes them as arguments, and takes its backend ("nccl"
for one process per card, "gloo" for CPU tensors or several processes on
one card) and rendezvous (``init_method``: ``tcp://host:port`` or
``file:///path``) explicitly.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "nccl", init_method: Optional[str] = None,
               timeout_s: float = 600.0) -> bool:
  """Join the process group; a no-op (False) for a single process.

  The rendezvous is `init_method`, else ``tcp://COORDINATOR_ADDRESS``;
  with neither there is nothing to join. `num_processes` and `process_id`
  default to ``NUM_PROCESSES`` (1) and ``PROCESS_ID`` (0).
  """
  coordinator_address = coordinator_address or os.environ.get(
      "COORDINATOR_ADDRESS")
  if init_method is None:
    if coordinator_address is None:
      return False
    init_method = f"tcp://{coordinator_address}"
  num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
  process_id = process_id if process_id is not None else int(
      os.environ.get("PROCESS_ID", "0"))
  dist.init_process_group(backend, init_method=init_method,
                          world_size=num_processes, rank=process_id,
                          timeout=datetime.timedelta(seconds=timeout_s))
  return True


def process_count() -> int:
  return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
  return dist.get_rank() if dist.is_initialized() else 0


def process_local_batch_slice(global_batch: int) -> Tuple[int, int]:
  """(local_batch, offset) for this process's share of the env batch."""
  n, i = process_count(), process_index()
  if global_batch % n:
    raise ValueError(f"global batch {global_batch} not divisible by {n}")
  local = global_batch // n
  return local, i * local


def staleness_metric(collect_params_step, train_step):
  """Collect-policy-vs-train-step lag (the reference's staleness metrics,
  train_utils.create_staleness_metrics_after_train_step_fn :49-120)."""
  return int(train_step) - int(collect_params_step)
