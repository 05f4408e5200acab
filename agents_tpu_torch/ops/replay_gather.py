"""Replay-sample row gather.

Port of `gather_rows` of ``agents_tpu/ops/replay_gather.py``. The JAX
package stores multi-KB rows as tile-aligned [r, 128] blocks, a layout of
the TPU's (8, 128) tiling; it has no counterpart on the card, so the port
keeps every row in its natural shape and gathers with `index_select`.
"""
from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
  """table: [N, ...row]; indices: [S] int64 -> [S, ...row]."""
  return table.index_select(0, indices)
