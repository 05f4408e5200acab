"""The LSTM recurrence's CUDA kernel (`ops/lstm_recurrence.py`,
``csrc/lstm_recurrence.cu``) and its routing in
`networks/lstm_networks.py:_MaskedLSTMUnroll`.

On the CPU: the unroll is the plain Python loop and never reaches the
kernel; the wrapper refuses what the kernel does not take; the nvcc build
(a stand-in compiler) locks and rebuilds only when the source is newer;
`torch.export` traces the plain loop; `chip_smoke.py`'s check of the
kernel's launches against the unrolls' counters. The tests marked `card`
hold the kernel against the plain loop on an NVIDIA card, each of its block
shapes, float32 with TF32 off, and skip without one:

    python3 -m pytest tests/test_torch_lstm_kernel.py -m card
"""
import os
import stat
import threading
import types

import numpy as np
import pytest
import torch

import chip_smoke
from agents_tpu_torch.networks import lstm_networks
from agents_tpu_torch.networks.lstm_networks import (LSTMEncoder,
                                                     _MaskedLSTMUnroll)
from agents_tpu_torch.ops.lstm_recurrence import KERNEL
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import native_build, profiling


def _inputs(rows, steps, size, device, seed=0):
  """Unroll inputs drawn with numpy: FIRST steps at scattered places inside
  the sequences (and at some first steps), a nonzero initial carry, and the
  gradients of the outputs and of the final carry."""
  rng = np.random.RandomState(seed)
  keep = (rng.rand(rows, steps) > 0.15).astype(np.float32)
  arrays = dict(
      gates_x=rng.randn(rows, steps, 4 * size) * 0.5,
      keep=keep,
      w_h=rng.randn(4 * size, size) / np.sqrt(size),
      c=rng.randn(rows, size), h=rng.randn(rows, size) * 0.5,
      d_out=rng.randn(rows, steps, size), d_c=rng.randn(rows, size),
      d_h=rng.randn(rows, size))
  return {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
          for k, v in arrays.items()}


def _unroll(x, grads=True):
  """(outputs, final c, final h) and, with `grads`, the gradients of
  gates_x, w_h, c and h under the drawn output gradients."""
  args = [x[k].clone().requires_grad_(grads and k != "keep")
          for k in ("gates_x", "keep", "w_h", "c", "h")]
  y, c, h = _MaskedLSTMUnroll.apply(*args, grads)
  if not grads:
    return (y, c, h), ()
  loss = (y * x["d_out"]).sum() + (c * x["d_c"]).sum() + (h * x["d_h"]).sum()
  got = torch.autograd.grad(loss, [args[i] for i in (0, 2, 3, 4)])
  return (y, c, h), got


# ----------------------------------------------------------------- CPU


def test_cpu_unroll_is_the_plain_loop(monkeypatch):
  """On the CPU no call reaches the kernel: the plain loop runs forward and
  backward, `lstm.steps` and `lstm.backward_steps` count, and
  `lstm.kernel_steps` does not."""
  def refuse(*args, **kwargs):
    raise AssertionError("the kernel ran on the CPU")

  monkeypatch.setattr(KERNEL, "forward", refuse)
  monkeypatch.setattr(KERNEL, "backward", refuse)
  x = _inputs(3, 5, 4, "cpu")
  launches = KERNEL.launches
  with profiling.record() as rec:
    (y, c, h), grads = _unroll(x)
  assert y.shape == (3, 5, 4) and all(g.isfinite().all() for g in grads)
  counters = rec.summary()["counters"]
  assert counters == {"lstm.steps": 5, "lstm.backward_steps": 5}
  assert KERNEL.launches == launches


def _fake(dtype=torch.float32, device="cuda:0", shape=(2, 3)):
  """Stands in for a tensor where the wrapper reads only device and type."""
  return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                               shape=shape)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64])
def test_wrapper_refuses_a_cuda_dtype_other_than_float32(dtype):
  args = [_fake() for _ in range(5)]
  args[0] = _fake(dtype)
  with pytest.raises(TypeError, match="float32 only; gates_x"):
    KERNEL.forward(*args, save=True)
  with pytest.raises(TypeError, match="float32 only; d_outputs"):
    KERNEL.backward(_fake(dtype), *[_fake() for _ in range(4)],
                    saved=(None,) * 4)


def test_wrapper_refuses_shapes_that_do_not_fit():
  """B=2, T=3, H=2: gates_x [2, 3, 8]; an h of width 3 or a d_h of 3 rows
  would send the kernel past its buffers."""
  args = [_fake(shape=s) for s in ((2, 3, 8), (2, 3), (8, 2), (2, 2),
                                   (2, 3))]
  with pytest.raises(ValueError, match="takes gates_x"):
    KERNEL.forward(*args, save=False)
  saved = (_fake(shape=(3, 2, 8)),) + (None,) * 3
  grads = [_fake(shape=s) for s in ((2, 3, 2), (2, 2), (3, 2))]
  with pytest.raises(ValueError, match="backward takes"):
    KERNEL.backward(*grads, _fake(shape=(2, 3)), _fake(shape=(8, 2)),
                    saved=saved)


def test_wrapper_refuses_tensors_off_the_card_or_split_between_cards():
  with pytest.raises(ValueError, match="w_h is on cpu"):
    KERNEL.forward(_fake(), _fake(), _fake(device="cpu"), _fake(), _fake(),
                   save=False)
  with pytest.raises(ValueError, match="h is on cuda:1"):
    KERNEL.forward(_fake(), _fake(), _fake(), _fake(),
                   _fake(device="cuda:1"), save=False)


# Three unrolls of 10 steps on the kernel, one of them trained: 30 forward
# launches, 10 backward ones and the backward's start.
ENGAGED = dict(launches=41, steps=30, kernel_steps=30, backward_steps=10,
               unrolls=3, backwards=1)
ENGAGED_ON_CARD = dict(forward=30, backward=10, start=1)


@pytest.mark.parametrize("counts, device_calls, failing", [
    ({}, {}, set()),
    (dict(launches=0, steps=0, kernel_steps=0, backward_steps=0,
          backwards=0), dict(forward=0, backward=0, start=0), {"launched"}),
    (dict(steps=40, unrolls=4), {},                  # a fourth, plain, unroll
     {"every_step_on_the_kernel", "one_launch_a_step_and_one_a_backward"}),
    (dict(launches=40), dict(start=0),                        # no start
     {"one_launch_a_step_and_one_a_backward", "card_ran_the_launches"}),
    (dict(launches=42), {}, {"one_launch_a_step_and_one_a_backward"}),
    ({}, dict(backward=11), {"card_ran_the_launches"}),       # one too many
    ({}, dict(forward=29), set()),                  # an event the trace lost
])
def test_chip_smoke_launch_checks(counts, device_calls, failing):
  """`chip_smoke.lstm_launch_checks` passes one launch a step and one a
  backward's start, every step on the kernel and the trace showing each
  launched function on the card, none more often than launched; each
  fault fails its own checks."""
  fields, ok = chip_smoke.lstm_launch_checks(
      dict(ENGAGED, **counts), 2, dict(ENGAGED_ON_CARD, **device_calls))
  assert {k for k, v in fields["checks"].items() if not v} == failing
  assert ok == (not failing)
  launches = dict(ENGAGED, **counts)["launches"]
  assert fields["launches_per_unit"] == launches / 2
  assert fields["launches_per_unroll"] == launches / dict(
      ENGAGED, **counts)["unrolls"]


def test_chip_smoke_records_a_cpu_unroll_off_the_kernel(monkeypatch):
  """`chip_smoke.lstm_recorded` zeroes the launch count and reads the
  unroll's counters and spans: a trained CPU unroll of 5 steps launches
  nothing, so its checks fail."""
  monkeypatch.setattr(KERNEL, "launches", 7)
  counts = {}
  with chip_smoke.lstm_recorded(counts):
    _unroll(_inputs(3, 5, 4, "cpu"))
  assert counts == dict(launches=0, steps=5, kernel_steps=0,
                        backward_steps=5, unrolls=1, backwards=1)
  fields, ok = chip_smoke.lstm_launch_checks(counts, 1)
  assert not ok and {k for k, v in fields["checks"].items() if not v} == {
      "launched", "every_step_on_the_kernel",
      "one_launch_a_step_and_one_a_backward"}


def _fake_nvcc(tmp_path, sleep=0.0, fail=False):
  """A stand-in `nvcc` that logs its call and writes its ``-o`` file."""
  log = tmp_path / "nvcc.log"
  script = tmp_path / "nvcc"
  script.write_text(
      "#!/bin/sh\n"
      f"echo \"$@\" >> {log}\n"
      f"sleep {sleep}\n"
      + ("echo 'error: refused' >&2; exit 2\n" if fail else "")
      + "while [ $# -gt 0 ]; do\n"
      "  if [ \"$1\" = -o ]; then echo built > \"$2\"; fi\n"
      "  shift\n"
      "done\n")
  script.chmod(script.stat().st_mode | stat.S_IEXEC)
  return str(script), log


def _calls(log):
  return log.read_text().splitlines() if log.exists() else []


def test_cuda_build_locks_and_rebuilds_only_when_the_source_is_newer(
    tmp_path, monkeypatch):
  csrc, build = tmp_path / "csrc", tmp_path / "build"
  csrc.mkdir()
  source = csrc / "kern.cu"
  source.write_text("// a kernel\n")
  nvcc, log = _fake_nvcc(tmp_path, sleep=0.3)
  monkeypatch.setattr(native_build, "CSRC_DIR", str(csrc))
  monkeypatch.setattr(native_build, "BUILD_DIR", str(build))
  monkeypatch.setattr(native_build, "nvcc", lambda: nvcc)

  paths = []
  threads = [threading.Thread(
      target=lambda: paths.append(native_build.build_cuda_library("kern")))
      for _ in range(4)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(timeout=60)
  assert not any(t.is_alive() for t in threads)
  library = str(build / "libagents_tpu_kern.so")
  assert paths == [library] * 4
  calls = _calls(log)
  assert len(calls) == 1               # the others waited on the lock
  for flag in ("arch=compute_90a,code=sm_90a", "-cudart shared", "-shared",
               f"-rpath,{os.path.dirname(tmp_path)}/lib64"):
    assert flag in calls[0]
  assert sorted(os.listdir(build)) == ["kern.lock", "libagents_tpu_kern.so"]

  assert native_build.build_cuda_library("kern") == library
  assert len(_calls(log)) == 1         # not older than its source
  later = os.path.getmtime(library) + 10
  os.utime(source, (later, later))
  native_build.build_cuda_library("kern")
  assert len(_calls(log)) == 2         # the source is newer


def test_cuda_build_failure_raises_and_leaves_no_library(tmp_path,
                                                         monkeypatch):
  csrc, build = tmp_path / "csrc", tmp_path / "build"
  csrc.mkdir()
  (csrc / "kern.cu").write_text("// a kernel\n")
  nvcc, _ = _fake_nvcc(tmp_path, fail=True)
  monkeypatch.setattr(native_build, "CSRC_DIR", str(csrc))
  monkeypatch.setattr(native_build, "BUILD_DIR", str(build))
  monkeypatch.setattr(native_build, "nvcc", lambda: nvcc)
  with pytest.raises(RuntimeError, match="error: refused"):
    native_build.build_cuda_library("kern")
  assert os.listdir(build) == ["kern.lock"]


def test_kernel_route_needs_a_card_and_no_export(monkeypatch):
  cuda = types.SimpleNamespace(is_cuda=True)
  assert lstm_networks._on_kernel(cuda)
  assert not lstm_networks._on_kernel(torch.zeros(1))
  monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
  assert not lstm_networks._on_kernel(cuda)


def test_export_traces_the_plain_loop(monkeypatch):
  """`torch.export` of an LSTM encoder asks for the route while exporting
  and traces the plain loop: a sigmoid per step, no kernel launch."""
  seen = []
  route = lstm_networks._on_kernel

  def spy(x):
    seen.append(torch.compiler.is_exporting())
    return route(x)

  monkeypatch.setattr(lstm_networks, "_on_kernel", spy)
  spec = (array_spec.ArraySpec((3,), np.float32),)
  encoder = LSTMEncoder(spec, (4,), 5, (4,), device="cpu",
                        generator=torch.Generator().manual_seed(0))

  class Step(torch.nn.Module):
    def __init__(self):
      super().__init__()
      self.encoder = encoder

    def forward(self, obs, step_type, c, h):
      return self.encoder((obs,), step_type, (c, h))

  args = (torch.randn(2, 6, 3), torch.ones(2, 6, dtype=torch.int32),
          torch.randn(2, 5), torch.randn(2, 5))
  launches = KERNEL.launches
  with torch.no_grad():
    program = torch.export.export(Step(), args)
  assert True in seen
  sigmoids = [n for n in program.graph.nodes
              if n.op == "call_function" and "sigmoid" in str(n.target)]
  assert len(sigmoids) == 6
  assert KERNEL.launches == launches
  with torch.no_grad():
    for a, b in zip(program.module()(*args), Step()(*args)):
      torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------- card


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card")
  tf32 = (torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  yield torch.device("cuda")
  (torch.backends.cuda.matmul.allow_tf32,
   torch.backends.cudnn.allow_tf32) = tf32


def _plain(monkeypatch, fn):
  """`fn()` with the unroll routed to the plain loop, on the card too."""
  with monkeypatch.context() as m:
    m.setattr(lstm_networks, "_on_kernel", lambda x: False)
    return fn()


# Both sides are float32 with FMA; they differ in the order of each sum:
# the kernel's k split over thread groups, cuBLAS's own tiling. Each
# product rounds at about K * 2^-24 of its terms' scale (K = H forward,
# 4H backward), and 80 steps carry that through the cell; so each tensor
# is held to max|kernel - plain| <= 1e-4 max|plain| + 1e-5.
RTOL, ATOL = 1e-4, 1e-5


def _close(tag, got, want):
  gap = (got - want).abs().max().item()
  limit = ATOL + RTOL * want.abs().max().item()
  assert gap <= limit, f"{tag}: {gap} > {limit}"


# Each of the forward's block shapes: 32 rows x 8 units where that grid
# fills the card (R2D2's unrolls; the CartPole collect at 4096 rows), else
# 16 x 4 (H = 40 at 64 and at a ragged 50 rows); 4-byte copies where H % 4.
@pytest.mark.card
@pytest.mark.parametrize("rows, steps, size", [
    (64, 40, 512), (64, 80, 512), (256, 1, 512),   # R2D2's unrolls: 32 x 8
    (4096, 2, 40),                                 # H = 40 at 32 x 8
    (64, 16, 40), (50, 10, 40),                    # H = 40 at 16 x 4
    (20, 5, 6),                                    # H % 4 != 0: 4-byte loads
])
def test_card_kernel_matches_the_plain_loop(card, monkeypatch, rows, steps,
                                            size):
  x = _inputs(rows, steps, size, card, seed=rows + steps + size)
  want, want_grads = _plain(monkeypatch, lambda: _unroll(x))
  got, got_grads = _unroll(x)
  torch.cuda.synchronize()
  for tag, a, b in zip(("outputs", "c", "h"), got, want):
    _close(tag, a, b)
  for tag, a, b in zip(("d_gates_x", "d_w_h", "d_c", "d_h"), got_grads,
                       want_grads):
    _close(tag, a, b)


@pytest.mark.card
def test_card_no_grad_unrolls_keep_nothing(card, monkeypatch):
  """An unroll under `torch.no_grad` (burn-in, targets, collect) keeps no
  saved buffers; one that trains keeps them."""
  saves = []
  forward = KERNEL.forward

  def spy(*args):
    out = forward(*args)
    saves.append((args[5], out[3] is None))
    return out

  monkeypatch.setattr(KERNEL, "forward", spy)
  spec = (array_spec.ArraySpec((3,), np.float32),)
  encoder = LSTMEncoder(spec, (8,), 16, (8,), device=card,
                        generator=torch.Generator(card).manual_seed(0))
  obs = torch.randn(4, 7, 3, device=card)
  step_type = torch.ones(4, 7, dtype=torch.int32, device=card)
  with torch.no_grad():
    encoder((obs,), step_type)
  y, _ = encoder((obs,), step_type)
  y.sum().backward()
  assert saves == [(False, True), (True, False)]
  assert encoder.lstm_hidden.weight.grad.abs().sum() > 0


@pytest.mark.card
def test_card_one_launch_a_step_and_one_for_the_backwards_start(card):
  x = _inputs(64, 12, 512, card)
  launches = KERNEL.launches
  with profiling.record() as rec:
    (y, c, h), _ = _unroll(x, grads=False)
    assert KERNEL.launches - launches == 12
    _unroll(x)
  torch.cuda.synchronize()
  assert KERNEL.launches - launches == 12 + 12 + 13
  counters = rec.summary()["counters"]
  assert counters["lstm.kernel_steps"] == counters["lstm.steps"] == 24


@pytest.mark.card
def test_card_unroll_makes_no_host_sync(card):
  x = _inputs(64, 8, 512, card)
  torch.cuda.synchronize()
  torch.cuda.set_sync_debug_mode("error")
  try:
    _unroll(x)
  finally:
    torch.cuda.set_sync_debug_mode("default")
