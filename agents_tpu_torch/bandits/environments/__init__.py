from agents_tpu_torch.bandits.environments.bandit_envs import (
    BanditTorchEnvironment,
    BernoulliBandit,
    ClassificationBandit,
    DriftingLinearBandit,
    RandomBandit,
    StationaryStochasticBandit,
    WheelBandit,
)
from agents_tpu_torch.bandits.environments.movielens import (
    MovieLensBandit,
    MovieLensPerArmBandit,
    load_movielens_data,
    synthetic_ratings_matrix,
)
from agents_tpu_torch.bandits.environments.nonstationary_envs import (
    NonStationaryStochasticBandit,
    PiecewiseBernoulliBandit,
    PiecewiseStationaryStochasticBandit,
    piece_schedule,
)
from agents_tpu_torch.bandits.environments.structured_envs import (
    BernoulliActionMaskBandit,
    ClickModel,
    ExplicitPositionalBiasRankingEnv,
    FeedbackModel,
    RankingBanditEnv,
    StationaryStochasticPerArmBandit,
    cascading_to_score_vector,
)
from agents_tpu_torch.bandits.environments import dataset_utilities
from agents_tpu_torch.bandits.environments import environment_utilities

__all__ = [
    "BanditTorchEnvironment", "BernoulliActionMaskBandit", "BernoulliBandit",
    "ClassificationBandit", "ClickModel", "DriftingLinearBandit",
    "ExplicitPositionalBiasRankingEnv",
    "FeedbackModel", "MovieLensBandit", "MovieLensPerArmBandit",
    "NonStationaryStochasticBandit", "PiecewiseBernoulliBandit",
    "PiecewiseStationaryStochasticBandit", "RandomBandit",
    "RankingBanditEnv", "StationaryStochasticBandit",
    "StationaryStochasticPerArmBandit", "WheelBandit",
    "cascading_to_score_vector", "dataset_utilities",
    "environment_utilities", "load_movielens_data", "piece_schedule",
    "synthetic_ratings_matrix",
]
