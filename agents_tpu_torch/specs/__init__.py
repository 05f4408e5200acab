from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.specs.array_spec import (
    ArraySpec, BoundedArraySpec, add_outer_dims_nest, check_arrays_nest,
    is_continuous, is_discrete, map_spec_nest, remove_outer_dims_nest,
    sample_spec, sample_spec_nest, spec_from_array_nest, zero_spec_nest)

__all__ = ["ArraySpec", "BoundedArraySpec", "add_outer_dims_nest",
           "array_spec", "check_arrays_nest", "is_continuous", "is_discrete",
           "map_spec_nest", "remove_outer_dims_nest", "sample_spec",
           "sample_spec_nest", "spec_from_array_nest", "zero_spec_nest"]
