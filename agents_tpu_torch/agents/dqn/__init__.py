from agents_tpu_torch.agents.dqn.dqn_agent import (D3qnAgent, DdqnAgent,
                                                   DqnAgent, DqnAgentState,
                                                   DqnLossExtra)

__all__ = ["D3qnAgent", "DdqnAgent", "DqnAgent", "DqnAgentState",
           "DqnLossExtra"]
