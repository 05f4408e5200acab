"""Sources of random draws.

The JAX package threads explicit PRNG keys; the port threads a draw source
instead. Every stochastic site asks the source for its draws by name, so a
run can take them from a `torch.Generator` on the device (`Draws`) or have
them replayed from a record (`ReplayDraws`): JAX's threefry and torch's
generators cannot agree, so the parity tests read the JAX package's draws
and replay them here, and the card-versus-CPU check replays one stream on
both devices.

Sites:
  "env_reset"           uniform [B, 4] in [-0.05, 0.05)  (CartPole reset)
  "pixels_target"       randint [B] in [0, num_actions)  (SyntheticPixels
                                                          reset)
  "pixels_step_target"  randint [B] in [0, num_actions)  (SyntheticPixels
                                                          step)
  "catch_ball_col"      randint [B] in [0, columns)      (Catch reset)
  "pendulum_theta"      uniform [B] in [-pi, pi)         (Pendulum reset)
  "pendulum_theta_dot"  uniform [B] in [-1, 1)           (Pendulum reset)
  "actor_noise"         normal [B, *leaf shape]          (ActorPolicy
                                                          and PPOPolicy
                                                          sample, one
                                                          draw per action
                                                          leaf); for a
                        uniform [B, K] in [tiny, 1)      categorical leaf
                                                          of K actions,
                                                          which `Categorical.
                                                          sample` turns
                                                          into Gumbel noise
                                                          (jax.random.
                                                          categorical's
                                                          "low" mode)
  "sac_next_action_noise"
                        normal [S, *leaf shape]          (SAC critic
                                                          targets' next
                                                          actions)
  "sac_action_noise"    normal [S, *leaf shape]          (SAC actor loss's
                                                          actions)
  "random_action"       randint [B] in [0, num_actions)  (epsilon-greedy)
  "explore"             uniform [B] in [0, 1)            (epsilon-greedy
                                                          coin)
  "replay_t0"           randint [S] in [0, num_valid)    (window start
                                                          offset)
  "replay_rows"         randint [S] in [0, B)            (env row)
  "ppo_permutation"     permutation [n_items]            (PPO: one per
                                                          epoch, the
                                                          shuffle of the
                                                          flattened frames)
"""
from __future__ import annotations

import collections
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch


class Draws:
  """Draws from one `torch.Generator` on `device`."""

  def __init__(self, seed: int = 0, device="cuda"):
    self.device = torch.device(device)
    self.generator = torch.Generator(device=self.device)
    self.generator.manual_seed(int(seed))

  def uniform(self, site: str, shape, low: float = 0.0, high: float = 1.0,
              dtype=torch.float32) -> torch.Tensor:
    del site
    u = torch.rand(tuple(shape), generator=self.generator, device=self.device,
                   dtype=dtype)
    return u * (high - low) + low

  def randint(self, site: str, shape, low: int, high: int,
              dtype=torch.int64) -> torch.Tensor:
    del site
    return torch.randint(int(low), int(high), tuple(shape),
                         generator=self.generator, device=self.device,
                         dtype=dtype)

  def normal(self, site: str, shape, dtype=torch.float32) -> torch.Tensor:
    del site
    return torch.randn(tuple(shape), generator=self.generator,
                       device=self.device, dtype=dtype)

  def permutation(self, site: str, n: int) -> torch.Tensor:
    """A random permutation of range(n), int64, on the device."""
    del site
    return torch.randperm(int(n), generator=self.generator,
                          device=self.device)


class ReplayDraws:
  """Replays recorded draws, one queue per site, in the order recorded.

  Every record is moved to `device` when the source is built, so replaying
  copies nothing from the host. A draw whose shape differs from the
  record's, or a site whose queue ran dry, raises.
  """

  def __init__(self, records: Mapping[str, Sequence], device="cpu"):
    self.device = torch.device(device)
    self._queues: Dict[str, collections.deque] = {
        site: collections.deque(
            torch.from_numpy(np.array(v)).to(self.device) for v in values)
        for site, values in records.items()}

  def remaining(self) -> Dict[str, int]:
    return {site: len(q) for site, q in self._queues.items()}

  def _next(self, site: str, shape, dtype) -> torch.Tensor:
    queue = self._queues.get(site)
    if not queue:
      raise LookupError(f"no recorded draws left for site {site!r}")
    value = queue.popleft()
    if tuple(value.shape) != tuple(shape):
      raise ValueError(
          f"site {site!r}: recorded draw has shape {tuple(value.shape)}, "
          f"asked for {tuple(shape)}")
    return value.to(dtype)

  def uniform(self, site, shape, low=0.0, high=1.0, dtype=torch.float32):
    return self._next(site, shape, dtype)

  def randint(self, site, shape, low, high, dtype=torch.int64):
    return self._next(site, shape, dtype)

  def normal(self, site, shape, dtype=torch.float32):
    return self._next(site, shape, dtype)

  def permutation(self, site, n):
    return self._next(site, (n,), torch.int64)


class RecordingDraws:
  """Passes draws through from `source` and keeps a CPU copy of each."""

  def __init__(self, source):
    self.source = source
    self.device = source.device
    self.records: Dict[str, List[np.ndarray]] = collections.defaultdict(list)

  def _keep(self, site, value):
    self.records[site].append(value.detach().cpu().numpy())
    return value

  def uniform(self, site, shape, low=0.0, high=1.0, dtype=torch.float32):
    return self._keep(site, self.source.uniform(site, shape, low, high, dtype))

  def randint(self, site, shape, low, high, dtype=torch.int64):
    return self._keep(site, self.source.randint(site, shape, low, high, dtype))

  def normal(self, site, shape, dtype=torch.float32):
    return self._keep(site, self.source.normal(site, shape, dtype))

  def permutation(self, site, n):
    return self._keep(site, self.source.permutation(site, n))


def as_draws(seed_or_draws, device):
  """A draw source: `seed_or_draws` itself, or `Draws(seed, device)`."""
  if isinstance(seed_or_draws, (int, np.integer)):
    return Draws(int(seed_or_draws), device)
  return seed_or_draws
