from agents_tpu_torch.agents.reinforce.reinforce_agent import (
    ReinforceAgent, ReinforceAgentState, ReinforceLossExtra)

__all__ = ["ReinforceAgent", "ReinforceAgentState", "ReinforceLossExtra"]
