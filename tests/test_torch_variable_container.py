"""The port's shared-memory weight store (`train/variable_container.py`):
twins of `tests/test_variable_container.py` (roundtrip, a structure
mismatch refused, readers in other processes never torn), a module's
state dict as the template, and the two packages reading each other's
payloads. Segment names carry the process id and a random suffix."""
import multiprocessing as mp
import os
import secrets

import numpy as np
import pytest
import torch

from agents_tpu.train import variable_container as jax_variable_container
from agents_tpu_torch.train.variable_container import VariableContainer


def _name(tag):
  return f"t_vc_{tag}_{os.getpid()}_{secrets.token_hex(4)}"


def _template():
  return {"dense": {"kernel": np.zeros((4, 3), np.float32),
                    "bias": np.zeros((3,), np.float32)},
          "step_scale": np.zeros((), np.int32)}


def _params(v):
  return {"dense": {"kernel": np.full((4, 3), v, np.float32),
                    "bias": np.full((3,), v * 2, np.float32)},
          "step_scale": np.asarray(v, np.int32)}


def test_push_pull_roundtrip():
  with VariableContainer(_name("rt"), _template(), create=True) as vc:
    assert vc.pull() is None and vc.step() == -1
    vc.push(_params(7), step=42)
    got, step = vc.pull()
    assert step == 42 and vc.step() == 42
    np.testing.assert_array_equal(got["dense"]["kernel"],
                                  np.full((4, 3), 7, np.float32))
    np.testing.assert_array_equal(got["dense"]["bias"],
                                  np.full((3,), 14, np.float32))
    assert int(got["step_scale"]) == 7
    vc.push(_params(9), step=43)
    got, step = vc.pull()
    assert step == 43 and int(got["step_scale"]) == 9
    assert vc.writes() == 2


def test_structure_mismatch_rejected():
  with VariableContainer(_name("bad"), _template(), create=True) as vc:
    with pytest.raises(ValueError):
      vc.push({"just_one_leaf": np.zeros((2,), np.float32)}, step=0)
    wrong_dtype = _params(1)
    wrong_dtype["step_scale"] = np.asarray(1, np.int64)
    with pytest.raises(ValueError):
      vc.push(wrong_dtype, step=0)
    wrong_shape = _params(1)
    wrong_shape["dense"]["bias"] = np.zeros((4,), np.float32)
    with pytest.raises(ValueError):
      vc.push(wrong_shape, step=0)


def test_create_refuses_a_live_segment_and_open_needs_one():
  name = _name("dup")
  with VariableContainer(name, _template(), create=True):
    with pytest.raises(OSError, match="already exists"):
      VariableContainer(name, _template(), create=True)
  with pytest.raises(OSError):
    VariableContainer(name, _template())          # unlinked on exit


def test_module_template_pushes_from_its_device_once_and_loads():
  """An `nn.Module` template: its state dict in order; `push` takes the
  module (tensors on its device) and `pull` gives a state dict that
  `load_state_dict` takes."""
  torch.manual_seed(0)
  src = torch.nn.Sequential(torch.nn.Linear(3, 5), torch.nn.ReLU(),
                            torch.nn.Linear(5, 2))
  dst = torch.nn.Sequential(torch.nn.Linear(3, 5), torch.nn.ReLU(),
                            torch.nn.Linear(5, 2))
  name = _name("mod")
  with VariableContainer(name, src, create=True) as writer:
    reader = VariableContainer(name, dst)
    writer.push(src, step=3)
    state_dict, step = reader.pull()
    assert step == 3 and list(state_dict) == list(src.state_dict())
    dst.load_state_dict(state_dict)
    for k, v in src.state_dict().items():
      assert torch.equal(dst.state_dict()[k], v)
    with pytest.raises(ValueError):
      writer.push(torch.nn.Linear(3, 5), step=4)
    reader.close()


@pytest.mark.parametrize("writer_side", ["jax", "port"])
def test_payloads_cross_packages(writer_side):
  """A nest pushed by one package pulls equal in the other (both lay its
  leaves out with dict keys sorted)."""
  name = _name(f"x{writer_side}")
  jcls, tcls = jax_variable_container.VariableContainer, VariableContainer
  wcls, rcls = (jcls, tcls) if writer_side == "jax" else (tcls, jcls)
  writer = wcls(name, _template(), create=True)
  try:
    reader = rcls(name, _template(), create=False)
    writer.push(_params(5), step=11)
    got, step = reader.pull()
    assert step == 11
    expect = _params(5)
    np.testing.assert_array_equal(np.asarray(got["dense"]["kernel"]),
                                  expect["dense"]["kernel"])
    np.testing.assert_array_equal(np.asarray(got["dense"]["bias"]),
                                  expect["dense"]["bias"])
    assert int(got["step_scale"]) == 5
    reader.close()
  finally:
    writer.close()
    writer.unlink()


def _reader_proc(name, n_pulls, q):
  vc = VariableContainer(name, _template())
  bad, max_step, pulled = 0, -1, 0
  while pulled < n_pulls:
    out = vc.pull()
    if out is None:
      continue
    params, step = out
    pulled += 1
    # All leaves were written together, so their relations hold exactly;
    # a torn read breaks them.
    v = float(params["dense"]["kernel"][0, 0])
    if not (params["dense"]["kernel"] == v).all():
      bad += 1
    elif not (params["dense"]["bias"] == 2 * v).all():
      bad += 1
    elif int(params["step_scale"]) != int(v) or step != int(v):
      bad += 1
    if step < max_step:            # latest wins: steps never go back
      bad += 1
    max_step = max(max_step, step)
  vc.close()
  q.put((bad, max_step))


def test_concurrent_cross_process_reads_never_tear():
  name = _name("mp")
  vc = VariableContainer(name, _template(), create=True)
  ctx = mp.get_context("spawn")
  q = ctx.Queue()
  readers = [ctx.Process(target=_reader_proc, args=(name, 200, q))
             for _ in range(2)]
  try:
    vc.push(_params(0), step=0)
    for r in readers:
      r.start()
    for v in range(1, 2000):
      vc.push(_params(v), step=v)
    results = [q.get(timeout=120) for _ in readers]
    for r in readers:
      r.join(timeout=30)
      assert not r.is_alive()
    for bad, max_step in results:
      assert bad == 0, f"{bad} torn or inconsistent snapshots"
      assert 0 <= max_step < 2000
  finally:
    for r in readers:
      if r.is_alive():
        r.kill()
        r.join()
    vc.close()
    vc.unlink()
