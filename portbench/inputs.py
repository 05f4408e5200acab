"""What the benchmark makes from `--seed`: the draw source handed to the
program, the weights handed to both the program and the reference, and
the host-side observation pool of the act traffic.

Each comes from its own stream, a seed derived from `--seed` and the
stream's name, so the same seed gives the same inputs.
"""
from __future__ import annotations

import collections
import zlib

import numpy as np
import torch

from agents_tpu_torch.utils.draws import Draws


def stream_seed(seed: int, stream: str) -> int:
  """A 63-bit seed of `stream` under the run's `seed` (any whole
  number)."""
  entropy = [int(seed) & (2**64 - 1), zlib.crc32(stream.encode())]
  return int(np.random.SeedSequence(entropy).generate_state(
      1, np.uint64)[0] >> np.uint64(1))


class SeededDraws(Draws):
  """The program's own draw source (``agents_tpu_torch/utils/draws.py``),
  seeded from the run's seed. While `recording`, a copy of each draw is
  kept under its site, in order, for the reference."""

  def __init__(self, seed: int, device):
    super().__init__(stream_seed(seed, "draws"), device)
    self.recording = True
    self.records = collections.defaultdict(list)

  def _keep(self, site, value):
    if self.recording:
      self.records[site].append(value.detach().clone())
    return value

  def uniform(self, site, shape, low=0.0, high=1.0, dtype=torch.float32):
    return self._keep(site, super().uniform(site, shape, low, high, dtype))

  def randint(self, site, shape, low, high, dtype=torch.int64):
    return self._keep(site, super().randint(site, shape, low, high, dtype))

  def normal(self, site, shape, dtype=torch.float32):
    return self._keep(site, super().normal(site, shape, dtype))


def make_weights(seed: int, leaves, device):
  """{name: float32 tensor} of `leaves` ((name, shape, std, mean)), all
  from one normal draw on the device."""
  generator = torch.Generator(device=torch.device(device))
  generator.manual_seed(stream_seed(seed, "weights"))
  sizes = [int(np.prod(shape)) for _, shape, _, _ in leaves]
  flat = torch.randn(sum(sizes), generator=generator,
                     device=torch.device(device))
  out, offset = {}, 0
  for (name, shape, std, mean), n in zip(leaves, sizes):
    out[name] = (flat[offset:offset + n] * std + mean).reshape(shape)
    offset += n
  return out


def observation_pool(seed: int, count: int, shape, dtype=np.uint8):
  """`count` host observations of `shape`, uniform over the dtype's
  range."""
  rng = np.random.default_rng(stream_seed(seed, "observations"))
  info = np.iinfo(dtype)
  return rng.integers(info.min, int(info.max) + 1, size=(count,) + tuple(shape),
                      dtype=dtype)
