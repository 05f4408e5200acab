from agents_tpu_torch.agents.ddpg.ddpg_agent import (DdpgAgent,
                                                     DdpgAgentState,
                                                     DdpgLossExtra)

__all__ = ["DdpgAgent", "DdpgAgentState", "DdpgLossExtra"]
