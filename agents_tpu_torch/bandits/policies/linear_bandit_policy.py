"""Linear bandit exploration policy (UCB / Thompson sampling).

Port of ``agents_tpu/bandits/policies/linear_bandit_policy.py``: scores
each arm from the sufficient statistics (A_k, b_k):
  UCB:  xᵀ theta_k + alpha sqrt(xᵀ A_k^{-1} x)
  TS:   xᵀ theta_tilde,  theta_tilde ~ N(theta_k, alpha^2 A_k^{-1})
with one batched [K, d, d] Cholesky factorization per call
(`torch.linalg.cholesky_ex`, whose status stays on the device, then
`torch.cholesky_solve` and `torch.linalg.solve_triangular`), so acting
makes no host read. TS draws one `eps` [K, d] per call at the site
"lints_eps", shared by every row, as the JAX package does.
"""
from __future__ import annotations

import enum

import torch

from agents_tpu_torch import distributions as dist_lib
from agents_tpu_torch.bandits.policies import linalg
from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import policy_step as ps


class ExplorationStrategy(enum.Enum):
  optimistic = 1  # LinUCB
  sampling = 2    # Thompson sampling


def ucb_scores(chol, theta, x, alpha):
  """xᵀ theta_k + alpha sqrt(xᵀ A_k^{-1} x): [B, K] from the factors
  `chol` [K, d, d] of A, theta [K, d] and contexts x [B, d]."""
  est = x @ theta.T                                       # [B, K]
  # Solve A_k z = x for each arm and row: z [K, d, B].
  z = torch.cholesky_solve(x.T.expand(chol.shape[0], -1, -1), chol)
  var = torch.einsum("bd,kdb->bk", x, z)
  return est + alpha * torch.sqrt(torch.clamp(var, min=0.0))


class LinearBanditPolicy(Policy):

  def __init__(self, time_step_spec, action_spec, strategy, alpha=1.0,
               emit_log_probability=False):
    super().__init__(time_step_spec, action_spec, clip=False)
    self.strategy = strategy
    self.alpha = alpha
    self.num_actions = action_spec.num_values
    self._action_dtype = array_spec.torch_dtype(action_spec.dtype)

  def _scores(self, agent_state, observation, draws=None):
    x = observation.reshape(observation.shape[0], -1).to(
        agent_state.a_mat.dtype)                          # [B, d]
    chol = linalg.cholesky(agent_state.a_mat)             # [K, d, d]
    theta = torch.cholesky_solve(agent_state.b_vec[..., None],
                                 chol)[..., 0]            # [K, d]
    if self.strategy == ExplorationStrategy.optimistic:
      return ucb_scores(chol, theta, x, self.alpha)
    # Thompson sampling: theta_tilde = theta + alpha L^{-T} eps, whose
    # covariance is alpha^2 A^{-1}.
    eps = draws.normal("lints_eps", theta.shape, dtype=theta.dtype)
    u = torch.linalg.solve_triangular(chol.transpose(-1, -2),
                                      eps[..., None], upper=True)[..., 0]
    return x @ (theta + self.alpha * u).T

  def _action(self, params, time_step, state, draws):
    scores = self._scores(params, time_step.observation, draws)
    action = torch.argmax(scores, dim=-1).to(self._action_dtype)
    return ps.PolicyStep(action=action, state=state, info=())

  def _distribution(self, params, time_step, state):
    if self.strategy != ExplorationStrategy.optimistic:
      # TS draws a fresh theta_tilde per action; a drawless distribution
      # would freeze the perturbation.
      raise NotImplementedError(
          "Thompson-sampling LinearBanditPolicy has no closed-form "
          "action distribution; use action() (the per-call theta draw "
          "IS the exploration).")
    scores = self._scores(params, time_step.observation)
    return ps.PolicyStep(
        action=dist_lib.Categorical(scores * 1e6, dtype=self._action_dtype),
        state=state, info=())
