"""`agents_tpu_torch.parallel.distributed` over two processes (the twin
of `tests/test_distributed_loopback.py`): `initialize` joins a gloo
group through a `file://` rendezvous in `tmp_path`, reading the process
count and id from ``NUM_PROCESSES`` and ``PROCESS_ID`` as the JAX module
does; both ranks agree on the count and take disjoint slices of the env
batch; without ``COORDINATOR_ADDRESS`` or an `init_method` it is a no-op.
Every rank is joined with a timeout and killed if it hangs."""
import json
import multiprocessing
import os

import torch.distributed as dist

from agents_tpu_torch.parallel import create_mesh, distributed

TIMEOUT_S = 120


def _child(init_file, rank, out):
  os.environ["NUM_PROCESSES"] = "2"
  os.environ["PROCESS_ID"] = str(rank)
  os.environ.pop("COORDINATOR_ADDRESS", None)
  ok = distributed.initialize(backend="gloo", init_method=f"file://{init_file}",
                              timeout_s=TIMEOUT_S)
  mesh = create_mesh(2, device="cpu")
  import torch
  x = mesh.all_gather_rows(torch.tensor([rank * 10.0]))
  result = (ok, distributed.process_count(), distributed.process_index(),
            distributed.process_local_batch_slice(8), x.tolist(),
            distributed.staleness_metric(3, 10))
  dist.destroy_process_group()
  with open(out, "w") as f:
    json.dump(result, f)


def test_two_process_loopback_initialize(tmp_path):
  ctx = multiprocessing.get_context("spawn")
  outs = [str(tmp_path / f"rank{r}.txt") for r in range(2)]
  procs = [ctx.Process(target=_child,
                       args=(str(tmp_path / "rendezvous"), r, outs[r]))
           for r in range(2)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(TIMEOUT_S)
  alive = [p.is_alive() for p in procs]
  for p in procs:
    if p.is_alive():
      p.kill()
      p.join(10)
  assert not any(alive), "a rank hung"
  assert [p.exitcode for p in procs] == [0, 0]
  results = [json.load(open(o)) for o in outs]
  for rank, (ok, count, index, local, gathered, lag) in enumerate(results):
    assert ok is True and count == 2 and index == rank
    assert local == [4, 4 * rank]   # the 8-row batch split across 2
    assert gathered == [0.0, 10.0]  # rank order
    assert lag == 7


def test_initialize_is_a_no_op_without_a_rendezvous(monkeypatch):
  monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
  assert distributed.initialize(backend="gloo") is False
  assert not dist.is_initialized()
  assert distributed.process_count() == 1
  assert distributed.process_local_batch_slice(8) == (8, 0)
  mesh = create_mesh(device="cpu")
  assert (mesh.size, mesh.rank, mesh.distributed) == (1, 0, False)
