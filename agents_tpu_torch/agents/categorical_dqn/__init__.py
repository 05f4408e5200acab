from agents_tpu_torch.agents.categorical_dqn.categorical_dqn_agent import (
    C51LossExtra, CategoricalDqnAgent, project_distribution)

__all__ = ["C51LossExtra", "CategoricalDqnAgent", "project_distribution"]
