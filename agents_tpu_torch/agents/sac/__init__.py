from agents_tpu_torch.agents.sac.sac_agent import (SacAgent, SacAgentState,
                                                   SacLossExtra)

__all__ = ["SacAgent", "SacAgentState", "SacLossExtra"]
