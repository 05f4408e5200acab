"""Array specs: shape/dtype(/bounds) descriptors for nest leaves.

Port of ``agents_tpu/specs/array_spec.py`` (`ArraySpec`, `BoundedArraySpec`,
`zero_spec_nest`, `sample_spec_nest`, `is_discrete`, `is_continuous`, and
the host helpers `np_sample_spec_nest`, `check_arrays_nest`,
`add_outer_dims_nest`, `remove_outer_dims_nest`, `spec_from_array_nest`).
Dtypes stay numpy dtypes, as in the JAX package; `torch_dtype` maps them
for tensor creation. Sampling takes a draw source
(`agents_tpu_torch.utils.draws`) in place of a PRNG key.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from agents_tpu_torch.utils import nest_utils

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
  """The torch dtype of a numpy dtype (or of anything np.dtype accepts)."""
  return _TORCH_DTYPES[np.dtype(dtype)]


def _canonical_shape(shape) -> Tuple[int, ...]:
  if shape is None:
    return ()
  return tuple(int(d) for d in shape)


class ArraySpec:
  """Describes a single array leaf: shape, dtype, name (hashable)."""

  __slots__ = ("_shape", "_dtype", "_name")

  def __init__(self, shape: Sequence[int], dtype, name: Optional[str] = None):
    self._shape = _canonical_shape(shape)
    self._dtype = np.dtype(dtype)
    self._name = name

  @property
  def shape(self) -> Tuple[int, ...]:
    return self._shape

  @property
  def dtype(self) -> np.dtype:
    return self._dtype

  @property
  def name(self) -> Optional[str]:
    return self._name

  def __repr__(self):
    return (f"{type(self).__name__}(shape={self._shape}, "
            f"dtype={self._dtype.name}, name={self._name!r})")

  def __eq__(self, other):
    return (type(other) is ArraySpec and self._shape == other._shape
            and self._dtype == other._dtype)

  def __hash__(self):
    return hash((self._shape, self._dtype.str))

  def check_array(self, array) -> bool:
    if isinstance(array, torch.Tensor):
      return (tuple(array.shape) == self._shape
              and array.dtype == torch_dtype(self._dtype))
    if isinstance(array, np.ndarray):
      return tuple(array.shape) == self._shape and array.dtype == self._dtype
    return False

  def replace(self, shape=None, dtype=None, name=None) -> "ArraySpec":
    return ArraySpec(self._shape if shape is None else shape,
                     self._dtype if dtype is None else dtype,
                     self._name if name is None else name)


class BoundedArraySpec(ArraySpec):
  """ArraySpec with inclusive `minimum`/`maximum` bounds (numpy arrays
  broadcastable to `shape`; the dtype's extremes when not given)."""

  __slots__ = ("_minimum", "_maximum")

  def __init__(self, shape, dtype, minimum=None, maximum=None,
               name: Optional[str] = None):
    super().__init__(shape, dtype, name)
    if np.issubdtype(self.dtype, np.integer):
      info = np.iinfo(self.dtype)
      lo, hi = info.min, info.max
    elif np.issubdtype(self.dtype, np.floating):
      info = np.finfo(self.dtype)
      lo, hi = info.min, info.max
    else:
      lo, hi = 0, 1
    self._minimum = np.array(lo if minimum is None else minimum,
                             dtype=self.dtype)
    self._maximum = np.array(hi if maximum is None else maximum,
                             dtype=self.dtype)
    if not np.all(self._minimum <= self._maximum):
      raise ValueError(
          f"Spec minimum {self._minimum} > maximum {self._maximum}")

  @property
  def minimum(self) -> np.ndarray:
    return self._minimum

  @property
  def maximum(self) -> np.ndarray:
    return self._maximum

  @property
  def num_values(self) -> int:
    """Number of discrete values of an integer spec."""
    if not np.issubdtype(self.dtype, np.integer):
      raise ValueError("num_values only defined for integer specs")
    return int(np.max(self._maximum) - np.min(self._minimum) + 1)

  def __repr__(self):
    return (f"BoundedArraySpec(shape={self._shape}, dtype={self._dtype.name}, "
            f"minimum={self._minimum}, maximum={self._maximum}, "
            f"name={self._name!r})")

  def __eq__(self, other):
    return (isinstance(other, BoundedArraySpec)
            and self._shape == other._shape and self._dtype == other._dtype
            and np.array_equal(self._minimum, other._minimum)
            and np.array_equal(self._maximum, other._maximum))

  def __hash__(self):
    return hash((self._shape, self._dtype.str,
                 self._minimum.tobytes(), self._maximum.tobytes()))

  def check_array(self, array) -> bool:
    if not super().check_array(array):
      return False
    values = (array.detach().cpu().numpy() if isinstance(array, torch.Tensor)
              else array)
    return bool(np.all(values >= self._minimum)
                and np.all(values <= self._maximum))

  def replace(self, shape=None, dtype=None, minimum=None, maximum=None,
              name=None) -> "BoundedArraySpec":
    return BoundedArraySpec(
        self._shape if shape is None else shape,
        self._dtype if dtype is None else dtype,
        self._minimum if minimum is None else minimum,
        self._maximum if maximum is None else maximum,
        self._name if name is None else name)


def _is_spec(x) -> bool:
  return isinstance(x, ArraySpec)


def map_spec_nest(fn, *nests):
  return nest_utils.tree_map(fn, *nests, is_leaf=_is_spec)


def is_discrete(spec: ArraySpec) -> bool:
  return np.issubdtype(spec.dtype, np.integer) or spec.dtype == np.bool_


def is_continuous(spec: ArraySpec) -> bool:
  return np.issubdtype(spec.dtype, np.floating)


def sample_spec(spec: ArraySpec, draws, outer_dims: Sequence[int] = (),
                site: str = "sample_spec") -> torch.Tensor:
  """One tensor conforming to `spec` with leading `outer_dims`.

  Bounded integer specs are uniform over the INCLUSIVE range
  [minimum, maximum]; bounded float specs are uniform; unbounded float
  specs standard normal; unbounded int specs uniform in [-2^28, 2^28);
  bool specs fair coins. The draws come from `draws` under `site`.
  """
  shape = tuple(outer_dims) + spec.shape
  dtype = torch_dtype(spec.dtype)
  if spec.dtype == np.bool_:
    return draws.uniform(site, shape) < 0.5
  if isinstance(spec, BoundedArraySpec):
    lo = np.broadcast_to(spec.minimum, spec.shape)
    hi = np.broadcast_to(spec.maximum, spec.shape)
    if np.issubdtype(spec.dtype, np.integer):
      if np.all(lo == lo.flat[0]) and np.all(hi == hi.flat[0]):
        return draws.randint(site, shape, int(lo.flat[0]),
                             int(hi.flat[0]) + 1).to(dtype)
      u = draws.uniform(site, shape, dtype=torch.float64)
      lo_t = torch.as_tensor(lo.astype(np.float64), device=u.device)
      span = torch.as_tensor(hi.astype(np.float64) - lo.astype(np.float64)
                             + 1.0, device=u.device)
      return torch.minimum(lo_t + torch.floor(u * span),
                           lo_t + span - 1).to(dtype)
    finfo = np.finfo(spec.dtype)
    lo_f, hi_f = lo.astype(np.float64), hi.astype(np.float64)
    if np.all(lo_f <= float(finfo.min) / 2) and \
        np.all(hi_f >= float(finfo.max) / 2):
      return draws.normal(site, shape, dtype=dtype)
    lo_c = np.maximum(lo_f, -1e18)
    hi_c = np.minimum(hi_f, 1e18)
    u = draws.uniform(site, shape, dtype=torch.float64)
    if np.all(lo_c == lo_c.flat[0]) and np.all(hi_c == hi_c.flat[0]):
      # One bound each: Python floats, so nothing is copied to the device.
      lo_s, hi_s = float(lo_c.flat[0]), float(hi_c.flat[0])
      return (lo_s + u * (hi_s - lo_s)).to(dtype)
    lo_t = torch.as_tensor(lo_c, device=u.device)
    hi_t = torch.as_tensor(hi_c, device=u.device)
    return (lo_t + u * (hi_t - lo_t)).to(dtype)
  if np.issubdtype(spec.dtype, np.integer):
    return draws.randint(site, shape, -(2**28), 2**28).to(dtype)
  return draws.normal(site, shape, dtype=dtype)


def sample_spec_nest(specs, draws, outer_dims: Sequence[int] = (),
                     site: str = "sample_spec"):
  """A nest of tensors conforming to a nest of specs."""
  return map_spec_nest(lambda s: sample_spec(s, draws, outer_dims, site),
                       specs)


def zero_spec_nest(specs, outer_dims: Sequence[int] = (), device=None):
  """Zero-valued nest conforming to specs."""
  outer = tuple(outer_dims)
  return map_spec_nest(
      lambda s: torch.zeros(outer + s.shape, dtype=torch_dtype(s.dtype),
                            device=device), specs)


def np_sample_spec_nest(specs, rng, outer_dims: Sequence[int] = ()):
  """A numpy nest conforming to `specs`, drawn from the
  `np.random.RandomState` `rng` leaf by leaf in the JAX package's order
  (dict keys sorted), with its calls, so that a host random action equals
  the JAX package's from the same state bit for bit.

  Integer bounded specs are uniform over the INCLUSIVE range [minimum,
  maximum]; bool specs fair coins; dtype-extreme (unbounded) float specs
  standard normal, bounded ones uniform within bounds clipped to +-1e6."""
  outer = tuple(outer_dims)

  def _one(s):
    shape = outer + tuple(s.shape)
    if isinstance(s, BoundedArraySpec):
      lo = np.broadcast_to(s.minimum, s.shape)
      hi = np.broadcast_to(s.maximum, s.shape)
      if np.issubdtype(s.dtype, np.integer):
        return rng.randint(np.broadcast_to(lo, shape),
                           np.broadcast_to(hi, shape).astype(np.int64) + 1
                           ).astype(s.dtype)
      if s.dtype == np.bool_:
        return rng.rand(*shape) < 0.5
      finfo = np.finfo(s.dtype)
      lo_f, hi_f = lo.astype(np.float64), hi.astype(np.float64)
      if np.all(lo_f <= float(finfo.min) / 2) and \
          np.all(hi_f >= float(finfo.max) / 2):
        return rng.standard_normal(shape).astype(s.dtype)
      lo_c = np.maximum(lo_f, -1e6)
      hi_c = np.minimum(hi_f, 1e6)
      return rng.uniform(np.broadcast_to(lo_c, shape),
                         np.broadcast_to(hi_c, shape)).astype(s.dtype)
    if np.issubdtype(s.dtype, np.integer):
      return rng.randint(-(2**28), 2**28, size=shape).astype(s.dtype)
    if s.dtype == np.bool_:
      return rng.rand(*shape) < 0.5
    return rng.standard_normal(shape).astype(s.dtype)

  return map_spec_nest_sorted(_one, specs)


def map_spec_nest_sorted(fn, *nests):
  """`map_spec_nest` calling `fn` in the JAX package's leaf order."""
  return nest_utils.tree_map_sorted(fn, *nests, is_leaf=_is_spec)


def _structure(nest, is_leaf):
  """A comparable description of `nest`'s containers (leaves as "*")."""
  if is_leaf(nest):
    return "*"
  if nest is None:
    return None
  if dataclasses.is_dataclass(nest) and not isinstance(nest, type):
    return (type(nest).__name__, tuple(
        (f.name, _structure(getattr(nest, f.name), is_leaf))
        for f in dataclasses.fields(nest)))
  if isinstance(nest, (tuple, list)):
    return (type(nest).__name__, tuple(_structure(c, is_leaf) for c in nest))
  if isinstance(nest, dict):
    return ("dict", tuple((k, _structure(nest[k], is_leaf))
                          for k in sorted(nest)))
  return "*"


def check_arrays_nest(arrays, specs) -> bool:
  """True iff `arrays` has `specs`' structure and every leaf conforms to
  its spec (shape, dtype and, for a bounded spec, bounds)."""
  is_array = lambda x: isinstance(x, (np.ndarray, torch.Tensor))  # noqa
  if _structure(arrays, is_array) != _structure(specs, _is_spec):
    return False
  return all(s.check_array(a) for s, a in zip(
      nest_utils.flatten_sorted(specs, is_leaf=_is_spec),
      nest_utils.flatten_sorted(arrays)))


def add_outer_dims_nest(specs, outer_dims: Sequence[int]):
  """Every spec's shape prefixed with `outer_dims`."""
  outer = tuple(outer_dims)
  return map_spec_nest(lambda s: s.replace(shape=outer + s.shape), specs)


def remove_outer_dims_nest(specs, num_outer_dims: int):
  """Every spec's shape without its `num_outer_dims` leading dims."""

  def _rm(s):
    if len(s.shape) < num_outer_dims:
      raise ValueError(f"Spec {s} has fewer than {num_outer_dims} outer dims")
    return s.replace(shape=s.shape[num_outer_dims:])

  return map_spec_nest(_rm, specs)


def spec_from_array_nest(arrays, num_outer_dims: int = 0):
  """An `ArraySpec` nest of `arrays` (numpy arrays or tensors) without
  their `num_outer_dims` leading dims."""

  def _leaf(a):
    dtype = (np.dtype(str(a.dtype).replace("torch.", ""))
             if isinstance(a, torch.Tensor) else a.dtype)
    return ArraySpec(tuple(a.shape)[num_outer_dims:], dtype)

  return nest_utils.tree_map(_leaf, arrays)
