from agents_tpu_torch.bandits.policies.linalg import (
    conjugate_gradient,
    simplified_woodbury_update,
    solve_spd,
    update_inverse,
)
from agents_tpu_torch.bandits.policies.constraints import (
    AbsoluteConstraint,
    BaseConstraint,
    InputNetworkConstraint,
    NeuralConstraint,
    QuantileConstraint,
    RelativeConstraint,
    RelativeQuantileConstraint,
    compute_feasibility_probability,
    construct_mask_from_multiple_sources,
    pinball_loss,
)
from agents_tpu_torch.bandits.policies.linear_bandit_policy import (
    ExplorationStrategy,
    LinearBanditPolicy,
)

__all__ = [
    "AbsoluteConstraint", "BaseConstraint", "ExplorationStrategy",
    "InputNetworkConstraint", "LinearBanditPolicy", "NeuralConstraint",
    "QuantileConstraint", "RelativeConstraint", "RelativeQuantileConstraint",
    "compute_feasibility_probability", "conjugate_gradient",
    "construct_mask_from_multiple_sources", "pinball_loss",
    "simplified_woodbury_update", "solve_spd", "update_inverse",
]
