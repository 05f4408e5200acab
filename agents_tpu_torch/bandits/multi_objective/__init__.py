from agents_tpu_torch.bandits.multi_objective.scalarizer import (
    ChebyshevScalarizer,
    HyperVolumeScalarizer,
    LinearScalarizer,
    Scalarizer,
)

__all__ = [
    "ChebyshevScalarizer", "HyperVolumeScalarizer", "LinearScalarizer",
    "Scalarizer",
]
