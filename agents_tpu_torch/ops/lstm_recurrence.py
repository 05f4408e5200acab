"""The reset-masked LSTM recurrence as a hand-written CUDA kernel.

`networks/lstm_networks.py:_MaskedLSTMUnroll` runs this on a CUDA tensor:
each time step of the forward and of the backward is one launch of
``agents_tpu_torch/csrc/lstm_recurrence.cu`` (its note says what the
kernel replaces and what bounds it). The source is compiled with `nvcc` on
first use (`utils/native_build.py:build_cuda_library`) and bound with
`ctypes`; nothing is built or loaded when this module is imported.

The wrapper checks the tensors' device, type and shapes, allocates every
output and saved buffer with `torch.empty`, sets the kernel's pointers once
per unroll, and launches on PyTorch's current stream of the tensors'
device; a launch that fails raises. The C side picks each step's block
shape from the rows and the width. The recurrent weight's gradient is one
`torch.mm` over all steps after the loop, as in the plain version.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from agents_tpu_torch.utils import native_build

_POINTERS = ("gates_x", "keep", "w", "h0", "c0", "out", "c", "h", "acts",
             "cells", "hiddens", "tanh_c")
_BACKWARD_POINTERS = ("keep", "wt", "d_out", "d_c", "d_h", "acts", "cells",
                      "tanh_c", "d_gates", "dc", "d_c0", "d_h0")


class _Forward(ctypes.Structure):
  _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS]
              + [(n, ctypes.c_int) for n in ("rows", "size", "steps",
                                             "device")])


class _Backward(ctypes.Structure):
  _fields_ = ([(n, ctypes.c_void_p) for n in _BACKWARD_POINTERS]
              + [(n, ctypes.c_int) for n in ("rows", "size", "steps",
                                             "device")])


def _check(**tensors):
  device = next(iter(tensors.values())).device
  for name, x in tensors.items():
    if x.device != device or x.device.type != "cuda":
      raise ValueError(f"the LSTM kernel takes CUDA tensors on one device; "
                       f"{name} is on {x.device}")
    if x.dtype != torch.float32:
      raise TypeError(f"the LSTM kernel takes float32 only; {name} is "
                      f"{x.dtype}")
  return device


class LstmKernel:
  """The loaded library and its count of launches (`launches`: one per
  forward step, one per backward step and one for each backward's
  start)."""

  def __init__(self):
    self.launches = 0
    self._lib = None
    self._lock = threading.Lock()

  def _library(self):
    with self._lock:
      if self._lib is None:
        lib = ctypes.CDLL(native_build.build_cuda_library("lstm_recurrence"))
        lib.lstm_forward.argtypes = [ctypes.POINTER(_Forward),
                                     ctypes.c_void_p]
        lib.lstm_backward.argtypes = [ctypes.POINTER(_Backward),
                                      ctypes.c_void_p]
        lib.lstm_forward.restype = lib.lstm_backward.restype = ctypes.c_int
        self._lib = lib
      return self._lib

  def forward(self, gates_x, keep, w_h, c, h, save: bool):
    """(outputs [B, T, H], final c, final h, saved) of the unroll of
    `_MaskedLSTMUnroll.forward`'s arguments; `saved` (for `backward`) is
    None unless `save`."""
    device = _check(gates_x=gates_x, keep=keep, w_h=w_h, c=c, h=h)
    rows, steps, gates = gates_x.shape
    size = gates // 4
    if (tuple(keep.shape), tuple(w_h.shape), tuple(c.shape),
        tuple(h.shape)) != ((rows, steps), (gates, size), (rows, size),
                            (rows, size)) or gates != 4 * size:
      raise ValueError(
          f"the LSTM kernel takes gates_x [B, T, 4H], keep [B, T], w_h "
          f"[4H, H], c and h [B, H]; got {tuple(gates_x.shape)}, "
          f"{tuple(keep.shape)}, {tuple(w_h.shape)}, {tuple(c.shape)}, "
          f"{tuple(h.shape)}")
    gates_x, keep, w_h, c, h = (x.contiguous()
                                for x in (gates_x, keep, w_h, c, h))
    new = lambda *shape: torch.empty(shape, dtype=torch.float32,  # noqa
                                     device=device)
    out, c_n, h_n = new(rows, steps, size), new(rows, size), new(rows, size)
    saved = None
    if save:
      saved = (new(steps, rows, 4 * size), new(steps, rows, size),
               new(steps, rows, size), new(steps, rows, size))
    pointers = [gates_x, keep, w_h, h, c, out, c_n, h_n] + list(
        saved or (None,) * 4)
    params = _Forward(
        *[None if x is None else x.data_ptr() for x in pointers], rows, size,
        steps, device.index)
    self._launch("lstm_forward", params, device)
    self.launches += steps
    return out, c_n, h_n, saved

  def backward(self, d_outputs, d_c, d_h, keep, w_h, saved):
    """(d gates_x [B, T, 4H], d w_h, d c, d h) of an unroll that `forward`
    ran with `save`, from the gradients of its outputs and final carry."""
    acts, cells, hiddens, tanh_c = saved
    device = _check(d_outputs=d_outputs, d_c=d_c, d_h=d_h, keep=keep,
                    w_h=w_h)
    steps, rows, gates = acts.shape
    size = gates // 4
    if (tuple(d_outputs.shape), tuple(d_c.shape), tuple(d_h.shape)) != (
        (rows, steps, size), (rows, size), (rows, size)):
      raise ValueError(
          f"the LSTM kernel's backward takes d_outputs [B, T, H], d_c and "
          f"d_h [B, H] of its forward's B={rows}, T={steps}, H={size}; got "
          f"{tuple(d_outputs.shape)}, {tuple(d_c.shape)}, "
          f"{tuple(d_h.shape)}")
    d_outputs, d_c, d_h = (x.contiguous() for x in (d_outputs, d_c, d_h))
    wt = w_h.t().contiguous()
    d_gates = torch.empty_like(acts)
    dc, d_c0, d_h0 = (torch.empty_like(d_c) for _ in range(3))
    pointers = [keep.contiguous(), wt, d_outputs, d_c, d_h, acts, cells,
                tanh_c, d_gates, dc, d_c0, d_h0]
    params = _Backward(*[x.data_ptr() for x in pointers], rows, size, steps,
                       device.index)
    self._launch("lstm_backward", params, device)
    self.launches += steps + 1
    d_w = d_gates.flatten(0, 1).t().mm(hiddens.flatten(0, 1))
    return d_gates.transpose(0, 1), d_w, d_c0, d_h0

  def _launch(self, name, params, device):
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(self._library(), name)(ctypes.byref(params), stream)
    if rc != 0:
      raise RuntimeError(f"{name} failed to launch: CUDA error {rc}")


KERNEL = LstmKernel()
