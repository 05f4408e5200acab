from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.specs.array_spec import ArraySpec, BoundedArraySpec

__all__ = ["ArraySpec", "BoundedArraySpec", "array_spec"]
