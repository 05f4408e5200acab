from agents_tpu_torch.distributions.distributions import (
    NEG_INF, Bernoulli, Beta, Categorical, Deterministic, Distribution,
    GumbelSoftmax,
    Independent, MaskedCategorical, Normal, OneHotCategorical,
    ShiftedCategorical, SquashedNormal, kl_divergence)

__all__ = ["Bernoulli", "Beta", "Categorical", "Deterministic",
           "Distribution", "GumbelSoftmax", "Independent", "MaskedCategorical", "NEG_INF",
           "Normal", "OneHotCategorical", "ShiftedCategorical",
           "SquashedNormal", "kl_divergence"]
