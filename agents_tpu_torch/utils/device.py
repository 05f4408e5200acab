"""Device resolution for the port's entry points.

Entry points default to the card and never fall back to the CPU on their
own: a caller that wants the CPU says so with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
  """`device` as a torch.device; raises if it names CUDA and there is none."""
  device = torch.device(device)
  if device.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError(
        f"device={str(device)!r} requested but torch.cuda.is_available() is "
        "False; pass device='cpu' to run on the CPU")
  return device
