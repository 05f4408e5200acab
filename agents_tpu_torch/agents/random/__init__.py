from agents_tpu_torch.agents.random.random_agent import (FixedPolicyAgent,
                                                         RandomAgent,
                                                         TrivialAgentState)

__all__ = ["FixedPolicyAgent", "RandomAgent", "TrivialAgentState"]
