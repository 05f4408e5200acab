from agents_tpu_torch.agents.ppo.ppo_agent import (PPOAgent, PPOAgentState,
                                                   PPOLossExtra)
from agents_tpu_torch.agents.ppo.ppo_policy import PPOPolicy
from agents_tpu_torch.agents.ppo.ppo_variants import (PPOClipAgent,
                                                      PPOKLPenaltyAgent)

__all__ = ["PPOAgent", "PPOAgentState", "PPOClipAgent", "PPOKLPenaltyAgent",
           "PPOLossExtra", "PPOPolicy"]
