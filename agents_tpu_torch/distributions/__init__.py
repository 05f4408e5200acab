from agents_tpu_torch.distributions.distributions import (Categorical,
                                                          Deterministic,
                                                          Independent, Normal,
                                                          SquashedNormal,
                                                          kl_divergence)

__all__ = ["Categorical", "Deterministic", "Independent", "Normal",
           "SquashedNormal", "kl_divergence"]
