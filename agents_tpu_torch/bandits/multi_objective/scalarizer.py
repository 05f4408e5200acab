"""Multi-objective scalarizers.

Port of ``agents_tpu/bandits/multi_objective/scalarizer.py``: `Scalarizer`,
`LinearScalarizer`, `ChebyshevScalarizer` and `HyperVolumeScalarizer`
over [..., num_objectives] tensors. Their weights are copied to a
tensor's device on first use there and kept: a copy from the host at
every call would sync the card's stream.
"""
from __future__ import annotations

import abc
from typing import Sequence

import numpy as np
import torch


class Scalarizer(abc.ABC):

  def __init__(self, num_of_objectives: int):
    if num_of_objectives < 2:
      raise ValueError("Need at least 2 objectives")
    self._num_of_objectives = num_of_objectives
    self._constants = {}

  @property
  def num_of_objectives(self):
    return self._num_of_objectives

  def _on(self, name: str, values, device) -> torch.Tensor:
    """`values` as a float32 tensor on `device`, made once."""
    key = (name, str(device))
    if key not in self._constants:
      self._constants[key] = torch.as_tensor(
          np.asarray(values, np.float32), device=device)
    return self._constants[key]

  def __call__(self, multi_objectives):
    if multi_objectives.shape[-1] != self._num_of_objectives:
      raise ValueError(
          f"Expected {self._num_of_objectives} objectives, got "
          f"{multi_objectives.shape[-1]}")
    return self._scalarize(multi_objectives)

  @abc.abstractmethod
  def _scalarize(self, multi_objectives):
    ...


class LinearScalarizer(Scalarizer):
  """Weighted sum."""

  def __init__(self, weights: Sequence[float]):
    super().__init__(len(weights))
    self._weights = np.asarray(weights, np.float32)

  def _scalarize(self, m):
    return torch.sum(m * self._on("w", self._weights, m.device), dim=-1)


class ChebyshevScalarizer(Scalarizer):
  """min_i w_i (m_i - ref_i)."""

  def __init__(self, weights: Sequence[float],
               reference_point: Sequence[float]):
    if len(weights) != len(reference_point):
      raise ValueError("weights and reference_point must match")
    super().__init__(len(weights))
    self._weights = np.asarray(weights, np.float32)
    self._ref = np.asarray(reference_point, np.float32)

  def _scalarize(self, m):
    w = self._on("w", self._weights, m.device)
    ref = self._on("ref", self._ref, m.device)
    return torch.min(w * (m - ref), dim=-1).values


class HyperVolumeScalarizer(Scalarizer):
  """min_i (max(m_i, 0) / direction_i) along a unit direction."""

  ALMOST_ZERO = 1e-6

  def __init__(self, direction: Sequence[float], transform_params=None):
    super().__init__(len(direction))
    d = np.asarray(direction, np.float64)
    norm = np.linalg.norm(d)
    if norm < self.ALMOST_ZERO:
      raise ValueError("direction must be nonzero")
    if np.any(d < 0):
      raise ValueError("direction must be non-negative")
    self._direction = np.maximum(d / norm, self.ALMOST_ZERO).astype(
        np.float32)

  def _scalarize(self, m):
    d = self._on("direction", self._direction, m.device)
    return torch.min(torch.clamp(m, min=0.0) / d, dim=-1).values
