"""Pure-Python TensorBoard event-file writer (no TensorFlow, no JAX).

Port of ``agents_tpu/utils/tb_writer.py``. The reference logs its training
and eval metrics as TF summaries readable by TensorBoard; this module
writes the same on-disk format, ``events.out.tfevents.*`` files: a
TFRecord stream of serialized ``tensorflow.Event`` protos, encoded by
hand. Given the same wall time it writes the JAX module's bytes.

Format notes (the stable, documented pieces only):
  TFRecord framing:  u64 length | u32 masked_crc32c(length_bytes)
                     | payload | u32 masked_crc32c(payload)
  masked crc:        ((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff
  Event proto:       1: wall_time (double)   2: step (int64)
                     3: file_version (string, first record only)
                     5: summary (Summary)
  Summary proto:     1: repeated Value { 1: tag (string),
                                         2: simple_value (float),
                                         5: histo (HistogramProto) }

Same ``scalar(name, value, step)`` surface as
``train.learner.JsonlSummaryWriter``, so the two are interchangeable in
the `Learner` and the examples; ``MultiWriter`` fans out to both.
"""
from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

try:  # fast C crc32c when available; pure-python fallback otherwise
  import google_crc32c

  def _crc32c(data: bytes) -> int:
    return int(google_crc32c.value(data))
except ImportError:  # pragma: no cover - environment dependent
  _CRC_TABLE = []

  def _crc32c(data: bytes) -> int:
    if not _CRC_TABLE:
      poly = 0x82F63B78
      for i in range(256):
        c = i
        for _ in range(8):
          c = (c >> 1) ^ poly if c & 1 else c >> 1
        _CRC_TABLE.append(c)
    crc = 0xFFFFFFFF
    for b in data:
      crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _host(values):
  """`values` as a float64 numpy array; a tensor is read back first."""
  if hasattr(values, "detach"):
    values = values.detach().cpu().numpy()
  return np.asarray(values, np.float64)


def _masked_crc(data: bytes) -> int:
  crc = _crc32c(data)
  return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
  out = bytearray()
  while True:
    b = n & 0x7F
    n >>= 7
    out.append(b | (0x80 if n else 0))
    if not n:
      return bytes(out)


def _key(field: int, wire: int) -> bytes:
  return _varint((field << 3) | wire)


def _bytes_field(field: int, payload: bytes) -> bytes:
  return _key(field, 2) + _varint(len(payload)) + payload


def _double_field(field: int, value: float) -> bytes:
  return _key(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
  return _key(field, 5) + struct.pack("<f", value)


def _int64_field(field: int, value: int) -> bytes:
  return _key(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _event(wall_time: float, step: int = 0, file_version: str = None,
           summary: bytes = None) -> bytes:
  msg = _double_field(1, wall_time) + _int64_field(2, step)
  if file_version is not None:
    msg += _bytes_field(3, file_version.encode())
  if summary is not None:
    msg += _bytes_field(5, summary)
  return msg


def _scalar_summary(tag: str, value: float) -> bytes:
  val = _bytes_field(1, tag.encode()) + _float_field(2, float(value))
  return _bytes_field(1, val)   # Summary.value (repeated, field 1)


def _packed_doubles(field: int, values) -> bytes:
  payload = b"".join(struct.pack("<d", float(v)) for v in values)
  return _bytes_field(field, payload)


def _histo_summary(tag: str, limits, counts, vmin: float, vmax: float,
                   num: float, total: float, sum_sq: float) -> bytes:
  # HistogramProto: 1 min, 2 max, 3 num, 4 sum, 5 sum_squares,
  # 6 bucket_limit (packed double), 7 bucket (packed double).
  histo = (_double_field(1, vmin) + _double_field(2, vmax)
           + _double_field(3, num) + _double_field(4, total)
           + _double_field(5, sum_sq)
           + _packed_doubles(6, limits) + _packed_doubles(7, counts))
  val = _bytes_field(1, tag.encode()) + _bytes_field(5, histo)
  return _bytes_field(1, val)


class TensorBoardEventWriter:
  """Writes scalars as a TensorBoard events file under ``logdir``."""

  def __init__(self, logdir: str):
    os.makedirs(logdir, exist_ok=True)
    fname = (f"events.out.tfevents.{int(time.time())}."
             f"{socket.gethostname()}.{os.getpid()}.v2")
    self._f = open(os.path.join(logdir, fname), "ab")
    self._record(_event(time.time(), file_version="brain.Event:2"))

  def _record(self, payload: bytes):
    header = struct.pack("<Q", len(payload))
    self._f.write(header)
    self._f.write(struct.pack("<I", _masked_crc(header)))
    self._f.write(payload)
    self._f.write(struct.pack("<I", _masked_crc(payload)))
    self._f.flush()

  def scalar(self, name: str, value: float, step: int):
    self._record(_event(time.time(), int(step),
                        summary=_scalar_summary(name, value)))

  def histogram(self, name: str, values, step: int, bins: int = 30):
    """Histogram of raw samples (the ``tf.summary.histogram`` analogue,
    used for weight/action distributions); a tensor is read back first."""
    v = _host(values).reshape(-1)
    if v.size == 0:
      return
    counts, edges = np.histogram(v, bins=bins)
    self._record(_event(time.time(), int(step), summary=_histo_summary(
        name, edges[1:], counts, float(v.min()), float(v.max()),
        float(v.size), float(v.sum()), float(np.square(v).sum()))))

  def histogram_from_counts(self, name: str, counts, step: int,
                            limits=None):
    """Histogram from precomputed per-bucket counts (e.g. the
    ChosenActionHistogram metric's action counts, reference
    metrics/tf_metrics.py:369). `limits[i]` is bucket i's right edge;
    defaults to 0..n-1 (one bucket per discrete value)."""
    c = _host(counts).reshape(-1)
    limits = (np.arange(c.size, dtype=np.float64) if limits is None
              else _host(limits))
    num = float(c.sum())
    total = float((limits * c).sum())
    sum_sq = float((np.square(limits) * c).sum())
    self._record(_event(time.time(), int(step), summary=_histo_summary(
        name, limits, c, float(limits.min()) if c.size else 0.0,
        float(limits.max()) if c.size else 0.0, num, total, sum_sq)))

  def close(self):
    self._f.close()


class MultiWriter:
  """Fan a `scalar`/`histogram` stream out to several writers (e.g.
  JSONL + TB). Writers lacking a histogram surface are skipped for
  histogram calls."""

  def __init__(self, *writers):
    self.writers = writers

  def scalar(self, name: str, value: float, step: int):
    for w in self.writers:
      w.scalar(name, value, step)

  def histogram(self, name: str, values, step: int, bins: int = 30):
    for w in self.writers:
      fn = getattr(w, "histogram", None)
      if fn is not None:
        fn(name, values, step, bins=bins)

  def histogram_from_counts(self, name: str, counts, step: int,
                            limits=None):
    for w in self.writers:
      fn = getattr(w, "histogram_from_counts", None)
      if fn is not None:
        fn(name, counts, step, limits=limits)

  def close(self):
    for w in self.writers:
      w.close()
