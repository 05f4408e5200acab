"""Linear-algebra helpers for linear bandits.

Port of ``agents_tpu/bandits/policies/linalg.py``: `conjugate_gradient`
(a Python loop of `num_iterations` steps, `d` by default, with no host
read), `simplified_woodbury_update`, `update_inverse` and `solve_spd`.
`solve_spd` factors with `torch.linalg.cholesky_ex`, which leaves its
`info` on the device, where `torch.linalg.cholesky` reads it back on the
host (a sync on the card).
"""
from __future__ import annotations

import torch


def conjugate_gradient(a_mat, b, num_iterations=None, tol: float = 1e-10):
  """Solve a_mat @ x = b for SPD a_mat by CG.

  a_mat: [d, d]; b: [d] or [d, k].
  """
  d = a_mat.shape[0]
  num_iterations = d if num_iterations is None else num_iterations
  x = torch.zeros_like(b)
  r = b - a_mat @ x
  p = r
  for _ in range(num_iterations):
    rr = torch.sum(r * r, dim=0)
    ap = a_mat @ p
    alpha = rr / torch.clamp(torch.sum(p * ap, dim=0), min=tol)
    x = x + alpha * p
    r_new = r - alpha * ap
    beta = torch.sum(r_new * r_new, dim=0) / torch.clamp(rr, min=tol)
    p = r_new + beta * p
    r = r_new
  return x


def simplified_woodbury_update(a_inv, x):
  """Rank-1 inverse update: (A + x xᵀ)^{-1} from A^{-1}.

  a_inv: [d, d]; x: [d].
  """
  ax = a_inv @ x
  denom = 1.0 + x @ ax
  return a_inv - torch.outer(ax, ax) / denom


def update_inverse(a_inv, x):
  """Alias of `simplified_woodbury_update` under the reference's name."""
  return simplified_woodbury_update(a_inv, x)


def cholesky(a_mat):
  """Lower Cholesky factor of a batch of SPD matrices, without reading the
  factorization's status back to the host."""
  return torch.linalg.cholesky_ex(a_mat).L


def solve_spd(a_mat, b, ridge: float = 0.0):
  """Batched SPD solve via Cholesky: a_mat [..., d, d], b [..., d]."""
  if ridge:
    eye = torch.eye(a_mat.shape[-1], dtype=a_mat.dtype, device=a_mat.device)
    a_mat = a_mat + ridge * eye
  return torch.cholesky_solve(b[..., None], cholesky(a_mat))[..., 0]
