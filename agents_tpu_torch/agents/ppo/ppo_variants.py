"""PPO variant configurations.

Port of ``agents_tpu/agents/ppo/ppo_variants.py`` (:12-40): thin
configurations of `PPOAgent`.
"""
from __future__ import annotations

from agents_tpu_torch.agents.ppo.ppo_agent import PPOAgent


class PPOClipAgent(PPOAgent):
  """Clip-only objective: importance-ratio clipping on, KL penalty off."""

  def __init__(self, time_step_spec, action_spec, optimizer_fn,
               actor_network, value_network,
               importance_ratio_clipping: float = 0.2, **kwargs):
    kwargs.setdefault("initial_adaptive_kl_beta", 0.0)
    kwargs.setdefault("kl_cutoff_factor", 0.0)
    super().__init__(time_step_spec, action_spec, optimizer_fn,
                     actor_network, value_network,
                     importance_ratio_clipping=importance_ratio_clipping,
                     **kwargs)


class PPOKLPenaltyAgent(PPOAgent):
  """KL-penalty objective: adaptive beta and cutoff, no ratio clipping."""

  def __init__(self, time_step_spec, action_spec, optimizer_fn,
               actor_network, value_network,
               initial_adaptive_kl_beta: float = 1.0,
               adaptive_kl_target: float = 0.01,
               kl_cutoff_factor: float = 2.0,
               kl_cutoff_coef: float = 1000.0, **kwargs):
    kwargs.setdefault("importance_ratio_clipping", 0.0)
    super().__init__(time_step_spec, action_spec, optimizer_fn,
                     actor_network, value_network,
                     initial_adaptive_kl_beta=initial_adaptive_kl_beta,
                     adaptive_kl_target=adaptive_kl_target,
                     kl_cutoff_factor=kl_cutoff_factor,
                     kl_cutoff_coef=kl_cutoff_coef, **kwargs)
