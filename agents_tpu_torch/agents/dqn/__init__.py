from agents_tpu_torch.agents.dqn.dqn_agent import (DdqnAgent, DqnAgent,
                                                   DqnAgentState,
                                                   DqnLossExtra)

__all__ = ["DdqnAgent", "DqnAgent", "DqnAgentState", "DqnLossExtra"]
