from agents_tpu_torch.agents.agent import Agent

__all__ = ["Agent"]
