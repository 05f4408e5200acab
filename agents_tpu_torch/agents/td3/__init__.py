from agents_tpu_torch.agents.td3.td3_agent import (Td3Agent, Td3AgentState,
                                                   Td3LossExtra)

__all__ = ["Td3Agent", "Td3AgentState", "Td3LossExtra"]
