from agents_tpu_torch.agents.behavioral_cloning.behavioral_cloning_agent import (  # noqa: E501
    BcAgentState, BehavioralCloningAgent)

__all__ = ["BcAgentState", "BehavioralCloningAgent"]
