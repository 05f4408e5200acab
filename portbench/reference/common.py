"""Plain PyTorch pieces the references share: precisions, layers, Adam,
the recorded draws, and the gaps that decide `correct`.

Nothing here imports the program. The references run in one of these
precisions:

  "float32"  float32 with TF32 off for matmul and cuDNN: the reference.
  "tf32"     float32 with TF32 on: the control of a float32 program.
  "bfloat16" every input and weight of a convolution or dense layer
             rounded to bfloat16, the products summed in float32 and each
             layer's output rounded to bfloat16: the rounding a bfloat16
             program does, the yardstick of its gaps.
  "fp8"      every input and weight of a convolution or dense layer
             rounded to float8 e4m3 with a per-tensor scale (amax / 448),
             the products summed in float32 and each layer's output
             rounded to bfloat16: the control of a bfloat16 program, as an
             fp8 GEMM with float32 accumulation and a bfloat16 output
             computes, up to the order of the sums. Gradients pass the
             roundings straight through, so a weight's gradient is taken
             against the rounded input, as in an fp8 layer.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32", "bfloat16", "fp8")
E4M3_MAX = 448.0


@contextlib.contextmanager
def precision_flags(precision: str):
  """TF32 on only for "tf32"; the previous flags come back after."""
  if precision not in PRECISIONS:
    raise ValueError(f"unknown precision {precision!r}")
  old = (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32)
  tf32 = precision == "tf32"
  torch.backends.cuda.matmul.allow_tf32 = tf32
  torch.backends.cudnn.allow_tf32 = tf32
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def fp8_round(x: torch.Tensor) -> torch.Tensor:
  """`x` rounded to e4m3 under a per-tensor scale, gradient straight
  through."""
  scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
  q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
  return x + (q - x).detach()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
  """`x` rounded to bfloat16, gradient straight through."""
  return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x.detach())


_OPERANDS = {"fp8": fp8_round, "bfloat16": bf16_round}


def linear(x, weight, bias, precision):
  if precision in _OPERANDS:
    r = _OPERANDS[precision]
    return bf16_round(F.linear(r(x), r(weight), bf16_round(bias)))
  return F.linear(x, weight, bias)


def conv2d(x, weight, bias, stride, precision):
  if precision in _OPERANDS:
    r = _OPERANDS[precision]
    return bf16_round(F.conv2d(r(x), r(weight), bf16_round(bias),
                               stride=stride))
  return F.conv2d(x, weight, bias, stride=stride)


def adam(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
         moments: Dict[str, list], step: int, lr: float, eps: float = 1e-8,
         betas=(0.9, 0.999)) -> None:
  """One Adam step in place (Kingma and Ba, Algorithm 1, with eps added
  to the bias-corrected root of the second moment)."""
  b1, b2 = betas
  with torch.no_grad():
    for name, p in params.items():
      g = grads[name]
      m, v = moments.setdefault(name, [torch.zeros_like(p),
                                       torch.zeros_like(p)])
      m.mul_(b1).add_(g, alpha=1 - b1)
      v.mul_(b2).addcmul_(g, g, value=1 - b2)
      m_hat = m / (1 - b1**step)
      v_hat = v / (1 - b2**step)
      p.sub_(lr * m_hat / (v_hat.sqrt() + eps))


class Recorded:
  """Draws handed over by site, each site's in the order they were
  drawn; a shape other than the one asked for raises."""

  def __init__(self, records: Dict[str, List[torch.Tensor]]):
    self._queues = {site: list(values) for site, values in records.items()}
    self._next = {site: 0 for site in records}

  def take(self, site: str, shape) -> torch.Tensor:
    i = self._next.get(site, 0)
    values = self._queues.get(site, [])
    if i >= len(values):
      raise LookupError(f"no recorded draw left at {site!r}")
    value = values[i]
    if tuple(value.shape) != tuple(shape):
      raise ValueError(f"{site!r}: recorded {tuple(value.shape)}, asked "
                       f"{tuple(shape)}")
    self._next[site] = i + 1
    return value


def ring_windows(storage: Dict[str, torch.Tensor], count: int,
                 capacity: int, t0_draw: torch.Tensor, rows: torch.Tensor,
                 n: int) -> Dict[str, torch.Tensor]:
  """[S, n, ...] windows of a time-major ring (``[capacity, B, ...]`` per
  leaf) that `count` frames have been written to: window i starts
  `t0_draw[i]` frames after the oldest one still held (frame
  ``count - min(count, capacity)``), in env row `rows[i]`; frame t is at
  slot ``t % capacity``."""
  device = next(iter(storage.values())).device
  lo = count - min(count, capacity)
  steps = torch.arange(n, device=device)
  slots = (lo + t0_draw.to(device, torch.int64)[:, None] + steps) % capacity
  rows = rows.to(device, torch.int64)[:, None]
  return {k: v[slots, rows] for k, v in storage.items()}


def same_padding(size: int, kernel: int, stride: int):
  """(low, high) padding that gives ceil(size / stride) outputs."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def median(values: List[float]) -> float:
  values = sorted(values)
  n = len(values)
  return 0.5 * (values[(n - 1) // 2] + values[n // 2])


def loss_gap(program: List[Dict[str, float]],
             reference: List[Dict[str, float]]) -> float:
  """For each kind of loss, the largest |program - reference| over the
  steps over the largest |reference| over the steps; the worst kind."""
  worst = 0.0
  for kind in reference[0]:
    scale = max(abs(r[kind]) for r in reference)
    gap = max(abs(p[kind] - r[kind]) for p, r in zip(program, reference))
    worst = max(worst, gap / scale if scale > 0 else
                (0.0 if gap == 0 else math.inf))
  return worst


def norm_gaps(program: Dict[str, torch.Tensor],
              reference: Dict[str, torch.Tensor], leaves=None
              ) -> Dict[str, float]:
  """Per leaf, |‖program‖ − ‖reference‖| over the larger of the reference
  leaf's norm and the median leaf's (a gap of norms, not the norm of the
  difference)."""
  names = list(reference) if leaves is None else list(leaves)
  ref = {n: float(reference[n].double().norm()) for n in names}
  prog = {n: float(program[n].double().norm()) for n in names}
  mid = median(list(ref.values()))
  out = {}
  for n in names:
    scale = max(ref[n], mid)
    gap = abs(prog[n] - ref[n])
    out[n] = gap / scale if scale > 0 else (0.0 if gap == 0 else math.inf)
  return out


def moved_leaves(grads: Dict[str, torch.Tensor], leaves, source_of) -> list:
  """The leaves whose change is compared: those whose reference gradient
  (a target leaf's: its source's) is at least a thousandth of the median
  leaf's; a gradient nought to rounding moves a leaf under Adam by
  round-off alone."""
  norms = {n: float(g.double().norm()) for n, g in grads.items()}
  floor = 1e-3 * median(list(norms.values()))
  return [n for n in leaves if norms[source_of(n)] >= floor]
