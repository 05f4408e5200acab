from agents_tpu_torch.agents.dqn.dqn_agent import (D3qnAgent, DdqnAgent,
                                                   DqnAgent, DqnAgentState,
                                                   DqnLossExtra)
from agents_tpu_torch.agents.dqn.r2d2_agent import R2d2Agent, R2d2LossExtra

__all__ = ["D3qnAgent", "DdqnAgent", "DqnAgent", "DqnAgentState",
           "DqnLossExtra", "R2d2Agent", "R2d2LossExtra"]
