"""Shared-memory variable container: learner -> collector weight sync.

Port of ``agents_tpu/train/variable_container.py``. The learner publishes
its parameters into POSIX shared memory behind a single-writer seqlock
(``native/varstore/varstore.cc``, built for the port by
`agents_tpu_torch.utils.native_build`) and collectors on the same host
`pull` the newest snapshot without a lock: a reader never sees a torn
payload, and `step` tells it which train step the payload is from.

Codec: the template's leaves as raw C-order bytes, concatenated. For an
`nn.Module` the leaves are its `state_dict` in order; for any other nest
(numpy arrays or tensors) they are in the JAX package's leaf order (a
dict's keys sorted), so a nest pushed by either package reads back in the
other. The template fixes the structure, shapes and dtypes on both sides;
a payload that does not match it raises.

`push` takes tensors on the card (or the CPU, or numpy) and copies them
to the host once: the leaves are flattened to bytes and concatenated on
their device, and the one buffer is read back. `pull` returns a
`state_dict` of CPU tensors for a module template (ready for
`load_state_dict`), else the template's nest of numpy arrays.
"""
from __future__ import annotations

import collections
import ctypes
import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.native_build import build_library

_lib = None


def _load():
  global _lib
  if _lib is None:
    lib = ctypes.CDLL(build_library("varstore"))
    lib.vs_create.restype = ctypes.c_void_p
    lib.vs_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.vs_open.restype = ctypes.c_void_p
    lib.vs_open.argtypes = [ctypes.c_char_p]
    lib.vs_write.restype = ctypes.c_int
    lib.vs_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                             ctypes.c_uint64, ctypes.c_int64]
    lib.vs_read.restype = ctypes.c_int
    lib.vs_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                            ctypes.c_uint64,
                            ctypes.POINTER(ctypes.c_uint64),
                            ctypes.POINTER(ctypes.c_int64)]
    lib.vs_step.restype = ctypes.c_int64
    lib.vs_step.argtypes = [ctypes.c_void_p]
    lib.vs_capacity.restype = ctypes.c_uint64
    lib.vs_capacity.argtypes = [ctypes.c_void_p]
    lib.vs_writes.restype = ctypes.c_uint64
    lib.vs_writes.argtypes = [ctypes.c_void_p]
    lib.vs_close.restype = None
    lib.vs_close.argtypes = [ctypes.c_void_p]
    lib.vs_unlink.restype = ctypes.c_int
    lib.vs_unlink.argtypes = [ctypes.c_char_p]
    _lib = lib
  return _lib


def _shm_name(name: str) -> str:
  return name if name.startswith("/") else "/" + name


def _leaves(params) -> list:
  """A params nest's leaves in codec order."""
  if isinstance(params, torch.nn.Module):
    return list(params.state_dict().values())
  return nest_utils.flatten_sorted(params)


def _dtype(leaf) -> np.dtype:
  if isinstance(leaf, torch.Tensor):
    return np.dtype(str(leaf.dtype).replace("torch.", ""))
  return np.asarray(leaf).dtype


class VariableContainer:
  """Push and pull a params nest through shared memory.

  Args:
    name: shm segment name (a leading '/' is added if missing).
    params_template: an `nn.Module` or a nest of arrays or tensors fixing
      the structure, shapes and dtypes on both sides.
    create: the learner creates the segment (refusing one that exists);
      collectors open it.
  """

  def __init__(self, name: str, params_template: Any, create: bool = False):
    self._lib = _load()
    self._module = isinstance(params_template, torch.nn.Module)
    if self._module:
      self._keys = list(params_template.state_dict())
    self._template = params_template
    leaves = _leaves(params_template)
    self._shapes = [tuple(np.shape(x)) for x in leaves]
    self._dtypes = [_dtype(x) for x in leaves]
    self._sizes = [int(np.prod(s, dtype=np.int64)) * d.itemsize
                   for s, d in zip(self._shapes, self._dtypes)]
    self._payload_bytes = sum(self._sizes)
    self.name = _shm_name(name)
    n = self.name.encode()
    self._h = (self._lib.vs_create(n, self._payload_bytes) if create
               else self._lib.vs_open(n))
    if not self._h:
      if create and os.path.exists("/dev/shm" + self.name):
        raise OSError(
            f"varstore segment {self.name} already exists (stale from a "
            "crashed or duplicate learner). Recreating it in place would "
            "orphan collectors mapped to the old segment, so create "
            "refuses; call VariableContainer.unlink_name(name) first if "
            "you own the name.")
      raise OSError(f"varstore {'create' if create else 'open'} failed "
                    f"for {self.name}")
    self._owner = create
    if self._lib.vs_capacity(self._h) < self._payload_bytes:
      self.close()
      raise ValueError(
          f"segment capacity is smaller than the template's payload of "
          f"{self._payload_bytes} bytes: template mismatch")
    self._buf = ctypes.create_string_buffer(self._payload_bytes)

  def _blob(self, params) -> bytes:
    """The payload bytes of `params`, checked against the template, read
    back to the host once."""
    leaves = _leaves(params)
    if len(leaves) != len(self._shapes):
      raise ValueError("params structure differs from template")
    for x, shape, dtype in zip(leaves, self._shapes, self._dtypes):
      if tuple(np.shape(x)) != shape or _dtype(x) != dtype:
        raise ValueError(f"params leaf {tuple(np.shape(x))} {_dtype(x)} "
                         f"differs from template {shape} {dtype}")
    if all(isinstance(x, torch.Tensor) for x in leaves):
      flat = torch.cat([x.detach().contiguous().reshape(-1).view(torch.uint8)
                        for x in leaves])
      return flat.cpu().numpy().tobytes()
    return b"".join(np.ascontiguousarray(np.asarray(x)).tobytes()
                    for x in leaves)

  # -- learner side ----------------------------------------------------------
  def push(self, params: Any, step: int) -> None:
    """Publish new weights for train step `step`."""
    blob = self._blob(params)
    rc = self._lib.vs_write(self._h, blob, len(blob), int(step))
    if rc != 0:
      raise ValueError(f"vs_write failed rc={rc}")

  # -- collector side --------------------------------------------------------
  def pull(self) -> Optional[Tuple[Any, int]]:
    """Newest (params, step) snapshot, or None before the first push."""
    ln = ctypes.c_uint64()
    st = ctypes.c_int64()
    rc = self._lib.vs_read(self._h, self._buf, self._payload_bytes,
                           ctypes.byref(ln), ctypes.byref(st))
    if rc == -2:
      return None
    if rc != 0:
      raise OSError(f"vs_read failed rc={rc}")
    if ln.value != self._payload_bytes:
      raise ValueError(f"payload of {ln.value} bytes, template "
                       f"{self._payload_bytes}")
    raw = self._buf.raw
    leaves, off = [], 0
    for shape, dtype, size in zip(self._shapes, self._dtypes, self._sizes):
      leaves.append(np.frombuffer(raw, dtype=dtype,
                                  count=int(np.prod(shape, dtype=np.int64)),
                                  offset=off).reshape(shape).copy())
      off += size
    if self._module:
      return collections.OrderedDict(
          (k, torch.from_numpy(v)) for k, v in zip(self._keys, leaves)), int(
              st.value)
    return nest_utils.unflatten_sorted(self._template, leaves), int(st.value)

  def step(self) -> int:
    """Train step of the newest payload (-1 before the first push)."""
    return int(self._lib.vs_step(self._h))

  def writes(self) -> int:
    return int(self._lib.vs_writes(self._h))

  @staticmethod
  def unlink_name(name: str) -> None:
    """Remove a (possibly stale) segment by name, e.g. before `create`
    when this process owns the name and any earlier owner is dead."""
    _load().vs_unlink(_shm_name(name).encode())

  def close(self) -> None:
    if self._h:
      self._lib.vs_close(self._h)
      self._h = None

  def unlink(self) -> None:
    self._lib.vs_unlink(self.name.encode())

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
    if self._owner:
      self.unlink()
