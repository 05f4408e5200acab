"""Python bindings for the native trajectory ingest ring.

Port of ``agents_tpu/replay_buffers/host_ingest.py`` (`FrameCodec`,
`IngestServer`, `IngestClient`). Collector processes push fixed-size
trajectory frames into a lock-free multi-producer ring in POSIX shared
memory (``native/ingest/ingest.cc``); the learner drains them as numpy
and moves each block to the device itself. The ring is the same C++
source as the JAX package's, built for the port by
`agents_tpu_torch.utils.native_build` into the port's own directory and
bound here with ctypes.

Frame codec: a frame (one env row) is its leaves' raw C-order bytes,
concatenated in the JAX package's leaf order (a dict's keys sorted, a
dataclass's or NamedTuple's fields in order), so one frame encodes to the
same bytes in both packages and either side can feed the other's ring.
"""
from __future__ import annotations

import ctypes
import time
from typing import Optional

import numpy as np

from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.native_build import build_library

_lib = None


def _load():
  global _lib
  if _lib is not None:
    return _lib
  lib = ctypes.CDLL(build_library("ingest"))
  lib.ingest_create.restype = ctypes.c_void_p
  lib.ingest_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                ctypes.c_uint64]
  lib.ingest_attach.restype = ctypes.c_void_p
  lib.ingest_attach.argtypes = [ctypes.c_char_p]
  for name in ("ingest_push", "ingest_try_push", "ingest_drain"):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_uint64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
  for name in ("ingest_frame_bytes", "ingest_capacity", "ingest_size",
               "ingest_dropped"):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_uint64
    fn.argtypes = [ctypes.c_void_p]
  lib.ingest_close.restype = None
  lib.ingest_close.argtypes = [ctypes.c_void_p]
  _lib = lib
  return lib


def _shm_name(name: str) -> str:
  return name if name.startswith("/") else "/" + name


class FrameCodec:
  """Flat byte codec for one spec-conforming frame."""

  def __init__(self, data_spec):
    self.data_spec = data_spec
    self.leaves = nest_utils.flatten_sorted(data_spec,
                                            is_leaf=array_spec._is_spec)
    self.offsets = []
    off = 0
    for s in self.leaves:
      nbytes = int(np.prod(s.shape, dtype=np.int64)) * np.dtype(
          s.dtype).itemsize
      self.offsets.append((off, nbytes))
      off += nbytes
    self.frame_bytes = off

  def encode_batch(self, frames) -> np.ndarray:
    """frames: nest of numpy arrays (or CPU tensors) with leaves [B, ...];
    returns [B, frame_bytes] uint8."""
    leaves = nest_utils.flatten_sorted(frames)
    if len(leaves) != len(self.leaves):
      raise ValueError(f"frames have {len(leaves)} leaves, the spec "
                       f"{len(self.leaves)}")
    b = np.shape(leaves[0])[0]
    out = np.empty((b, self.frame_bytes), np.uint8)
    for leaf, spec, (off, nbytes) in zip(leaves, self.leaves, self.offsets):
      arr = np.ascontiguousarray(np.asarray(leaf, np.dtype(spec.dtype)))
      out[:, off:off + nbytes] = arr.reshape(b, -1).view(np.uint8)
    return out

  def decode_batch(self, buf: np.ndarray):
    """buf: [B, frame_bytes] uint8 -> nest of numpy [B, ...] leaves."""
    b = buf.shape[0]
    leaves = []
    for spec, (off, nbytes) in zip(self.leaves, self.offsets):
      raw = np.ascontiguousarray(buf[:, off:off + nbytes])
      leaves.append(raw.view(np.dtype(spec.dtype)).reshape((b,) + spec.shape))
    return nest_utils.unflatten_sorted(self.data_spec, leaves,
                                       is_leaf=array_spec._is_spec)


class IngestServer:
  """Learner side: creates the ring (replacing a stale one of the same
  name) and drains it."""

  def __init__(self, name: str, data_spec, capacity: int = 1 << 14):
    self.codec = FrameCodec(data_spec)
    self._lib = _load()
    self.name = _shm_name(name)
    self._h = self._lib.ingest_create(self.name.encode(),
                                      self.codec.frame_bytes, capacity)
    if not self._h:
      raise RuntimeError(f"ingest_create failed for {name} (capacity must "
                         "be a power of two)")

  def size(self) -> int:
    return int(self._lib.ingest_size(self._h))

  def dropped(self) -> int:
    return int(self._lib.ingest_dropped(self._h))

  def drain(self, max_frames: int = 4096):
    """Up to `max_frames` frames as a decoded numpy nest, or None."""
    buf = np.empty((max_frames, self.codec.frame_bytes), np.uint8)
    n = int(self._lib.ingest_drain(
        self._h, buf.ctypes.data_as(ctypes.c_void_p), max_frames))
    if n == 0:
      return None
    return self.codec.decode_batch(buf[:n])

  def close(self):
    """Unmaps and unlinks the ring."""
    if self._h:
      self._lib.ingest_close(self._h)
      self._h = None

  def __del__(self):
    if getattr(self, "_h", None):
      self.close()


class IngestClient:
  """Collector side: attaches to a ring by name and pushes frames."""

  def __init__(self, name: str, data_spec):
    self.codec = FrameCodec(data_spec)
    self._lib = _load()
    self.name = _shm_name(name)
    self._h = self._lib.ingest_attach(self.name.encode())
    if not self._h:
      raise RuntimeError(f"ingest_attach failed for {name}")
    if int(self._lib.ingest_frame_bytes(self._h)) != self.codec.frame_bytes:
      self.close()
      raise ValueError("frame_bytes mismatch: spec disagrees with server")

  def push(self, frames) -> int:
    """Push [B, ...] frames; returns how many the ring took (a full ring
    drops the rest and counts them in `dropped`)."""
    buf = self.codec.encode_batch(frames)
    return int(self._lib.ingest_push(
        self._h, buf.ctypes.data_as(ctypes.c_void_p), buf.shape[0]))

  def push_blocking(self, frames, timeout: Optional[float] = None,
                    poll_interval: float = 0.002) -> int:
    """Push all frames, waiting for ring space instead of dropping (the
    producer half of Reverb-style rate limiting: a full ring means the
    learner is behind). Returns the frames accepted, fewer than B only on
    timeout."""
    buf = self.codec.encode_batch(frames)
    total, sent = buf.shape[0], 0
    deadline = None if timeout is None else time.monotonic() + timeout
    while sent < total:
      chunk = np.ascontiguousarray(buf[sent:])
      sent += int(self._lib.ingest_try_push(
          self._h, chunk.ctypes.data_as(ctypes.c_void_p), chunk.shape[0]))
      if sent < total:
        if deadline is not None and time.monotonic() >= deadline:
          break
        time.sleep(poll_interval)
    return sent

  def close(self):
    if self._h:
      self._lib.ingest_close(self._h)
      self._h = None
