"""Reverb-style rate limiters for the host ingest -> learner path.

Port of ``agents_tpu/replay_buffers/rate_limiter.py``: `RateLimiter`,
`MinSize` and `SampleToInsertRatio` with the blocking `insert` / `sample`
and their timeouts. The limiters are host-side coordination in pure
Python, so this is the port's own copy of them; Reverb's semantics are
unchanged (``reverb.rate_limiters.MinSize`` and ``SampleToInsertRatio``,
as the reference builds its tables with in
``tf_agents/train/utils/replay_buffer_utils.py:29-56``).

One limiter gates one learner process: frames drained from the ingest
rings count as inserts, device sample batches as samples. Cross-process
producer backpressure is the ring itself (``IngestClient.push_blocking``
waits for space instead of dropping).
"""
from __future__ import annotations

import threading
from typing import Optional


class RateLimiter:
  """Base: track inserts/samples under a lock; subclasses define gating."""

  def __init__(self):
    self._cond = threading.Condition()
    self._inserts = 0
    self._samples = 0

  # -- state -----------------------------------------------------------------
  @property
  def inserts(self) -> int:
    return self._inserts

  @property
  def samples(self) -> int:
    return self._samples

  def can_insert(self, n: int = 1) -> bool:
    with self._cond:
      return self._can_insert(n)

  def can_sample(self, n: int = 1) -> bool:
    with self._cond:
      return self._can_sample(n)

  def record_insert(self, n: int = 1) -> None:
    """Unconditionally account n inserts that already happened (e.g.
    frames drained from the ingest ring after a `can_insert` gate)."""
    with self._cond:
      self._inserts += n
      self._cond.notify_all()

  def record_sample(self, n: int = 1) -> None:
    """Unconditionally account n samples that already happened."""
    with self._cond:
      self._samples += n
      self._cond.notify_all()

  # -- blocking ops ------------------------------------------------------------
  def insert(self, n: int = 1, timeout: Optional[float] = None) -> bool:
    """Record n inserts, blocking first while the limiter forbids them.
    Returns False on timeout (nothing recorded)."""
    with self._cond:
      if not self._cond.wait_for(lambda: self._can_insert(n),
                                 timeout=timeout):
        return False
      self._inserts += n
      self._cond.notify_all()
      return True

  def sample(self, n: int = 1, timeout: Optional[float] = None) -> bool:
    """Record n samples, blocking first while the limiter forbids them.
    Returns False on timeout (nothing recorded)."""
    with self._cond:
      if not self._cond.wait_for(lambda: self._can_sample(n),
                                 timeout=timeout):
        return False
      self._samples += n
      self._cond.notify_all()
      return True

  # -- subclass hooks ----------------------------------------------------------
  def _can_insert(self, n: int) -> bool:
    raise NotImplementedError

  def _can_sample(self, n: int) -> bool:
    raise NotImplementedError


class MinSize(RateLimiter):
  """Sampling blocks until at least `min_size_to_sample` items were
  inserted; inserts are never blocked (reverb.rate_limiters.MinSize, used
  by the reference's uniform tables, replay_buffer_utils.py:29-56)."""

  def __init__(self, min_size_to_sample: int):
    super().__init__()
    if min_size_to_sample < 1:
      raise ValueError("min_size_to_sample must be >= 1")
    self.min_size_to_sample = min_size_to_sample

  def _can_insert(self, n: int) -> bool:
    return True

  def _can_sample(self, n: int) -> bool:
    return self._inserts >= self.min_size_to_sample


class SampleToInsertRatio(RateLimiter):
  """Keep samples ~= samples_per_insert x inserts within an error buffer.

  Mirrors reverb.rate_limiters.SampleToInsertRatio: with
  ``d = inserts * samples_per_insert - samples``, sampling requires
  ``inserts >= min_size_to_sample`` and ``d > min_diff``; inserting
  requires ``d < max_diff`` (a fast collector blocks once the trainer
  falls `error_buffer` samples behind the target ratio, and a fast
  trainer blocks once it runs `error_buffer` ahead).

  Args:
    samples_per_insert: target ratio (e.g. SAC's UTD x batch scaling).
    min_size_to_sample: MinSize floor before any sampling.
    error_buffer: scalar slack (in samples) or explicit
      ``(min_diff, max_diff)`` bounds on ``d``.
  """

  def __init__(self, samples_per_insert: float, min_size_to_sample: int,
               error_buffer):
    super().__init__()
    if samples_per_insert <= 0:
      raise ValueError("samples_per_insert must be > 0")
    if min_size_to_sample < 1:
      raise ValueError("min_size_to_sample must be >= 1")
    self.samples_per_insert = float(samples_per_insert)
    self.min_size_to_sample = min_size_to_sample
    if isinstance(error_buffer, (tuple, list)):
      self.min_diff, self.max_diff = map(float, error_buffer)
    else:
      eb = float(error_buffer)
      center = min_size_to_sample * self.samples_per_insert
      self.min_diff = center - eb
      self.max_diff = center + eb
    if self.min_diff > self.max_diff:
      raise ValueError("min_diff must be <= max_diff")
    # The first insert must always be allowed or nothing can ever start;
    # reverb enforces the same (single insert always progresses).
    if self.samples_per_insert > self.max_diff:
      raise ValueError(
          "error_buffer too small: a single insert overshoots max_diff, "
          "so the system would deadlock before the first sample")

  def _diff(self) -> float:
    return self._inserts * self.samples_per_insert - self._samples

  def _can_insert(self, n: int) -> bool:
    # Inserts below the MinSize floor are always allowed (the table has
    # to be able to fill to min_size before the first sample happens).
    if self._inserts < self.min_size_to_sample:
      return True
    return self._diff() + n * self.samples_per_insert <= self.max_diff

  def _can_sample(self, n: int) -> bool:
    if self._inserts < self.min_size_to_sample:
      return False
    return self._diff() - n >= self.min_diff
