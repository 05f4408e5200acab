from agents_tpu_torch.bandits.agents.linear_bandit_agent import (
    LinearBanditAgent,
    LinearBanditState,
    LinearThompsonSamplingAgent,
    LinUcbAgent,
)
from agents_tpu_torch.bandits.agents.neural_bandit_agents import (
    BernoulliThompsonSamplingAgent,
    Exp3Agent,
    GreedyRewardPredictionAgent,
    NeuralBoltzmannAgent,
    NeuralEpsilonGreedyAgent,
    NeuralFalconAgent,
    NeuralLinUcbAgent,
)

__all__ = [
    "BernoulliThompsonSamplingAgent", "Exp3Agent",
    "GreedyRewardPredictionAgent", "LinUcbAgent", "LinearBanditAgent",
    "LinearBanditState", "LinearThompsonSamplingAgent",
    "NeuralBoltzmannAgent", "NeuralEpsilonGreedyAgent", "NeuralFalconAgent",
    "NeuralLinUcbAgent",
]
from agents_tpu_torch.bandits.agents.mixture_and_ranking_agents import (
    DropoutThompsonSamplingAgent,
    Exp3MixtureAgent,
    GreedyMultiObjectiveNeuralAgent,
    MixtureAgent,
    RankingAgent,
    StaticMixtureAgent,
)

__all__ += [
    "DropoutThompsonSamplingAgent", "Exp3MixtureAgent",
    "GreedyMultiObjectiveNeuralAgent", "MixtureAgent", "RankingAgent",
    "StaticMixtureAgent",
]
