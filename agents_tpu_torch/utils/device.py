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


def check_devices(device: torch.device, **parts) -> None:
  """Raise unless every named part (its `.device`) lives on `device`'s
  type of device."""
  for name, part in parts.items():
    if part.device.type != device.type:
      raise ValueError(f"{name} lives on {part.device}, the loop on {device}")
