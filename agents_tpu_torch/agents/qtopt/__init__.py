from agents_tpu_torch.agents.qtopt.qtopt_agent import (QtOptAgent,
                                                       QtOptAgentState,
                                                       QtOptLossExtra)

__all__ = ["QtOptAgent", "QtOptAgentState", "QtOptLossExtra"]
