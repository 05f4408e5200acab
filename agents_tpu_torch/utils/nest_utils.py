"""Nest ("pytree") algebra for the port.

Port of the parts of ``agents_tpu/utils/nest_utils.py`` the main path uses.
Torch has no public registered-dataclass pytrees, so this module is the
port's one tree utility. A nest is built from:

  - dataclass instances (the port's TimeStep, Trajectory, ... are frozen
    dataclasses; children are their fields, rebuilt with the constructor).
    A field declared with `static_field` (metadata ``{"static": True}``)
    is no child: `tree_map` passes it through from the first nest and
    `flatten` skips it, as flax's ``pytree_node=False`` fields are (a
    distribution's `dtype` or event dims),
  - NamedTuples, tuples and lists,
  - dicts (children in insertion order),
  - None and () (empty nodes);

anything else (a tensor, a numpy array, a number, an ArraySpec) is a leaf.

`tree_map` and `flatten` visit a dict's children in insertion order. The
host helpers that must lay out or draw leaves as the JAX package does
(``jax.tree_util`` sorts dict keys) use `tree_map_sorted`,
`flatten_sorted` and `unflatten_sorted`, which visit dict children in
sorted-key order and rebuild each dict in its own key order. The numpy
helpers below (`stack_nested_arrays` ... `get_outer_shape`) port those of
``agents_tpu/utils/nest_utils.py`` the host environments and loops use;
each takes numpy arrays or tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch


def _is_dataclass_instance(x) -> bool:
  return dataclasses.is_dataclass(x) and not isinstance(x, type)


def static_field(**kwargs):
  """A dataclass field that is no child of the nest (``dataclasses.field``
  with metadata ``{"static": True}``)."""
  return dataclasses.field(metadata={"static": True}, **kwargs)


def _is_static(f: dataclasses.Field) -> bool:
  return bool(f.metadata.get("static"))


def _map(fn: Callable, tree, rest, is_leaf, sort_keys: bool):
  if is_leaf is not None and is_leaf(tree):
    return fn(tree, *rest)
  if tree is None:
    return None
  if _is_dataclass_instance(tree):
    return type(tree)(**{
        f.name: getattr(tree, f.name) if _is_static(f) else _map(
            fn, getattr(tree, f.name), [getattr(r, f.name) for r in rest],
            is_leaf, sort_keys)
        for f in dataclasses.fields(tree)})
  if isinstance(tree, (tuple, list)):
    for r in rest:
      if len(r) != len(tree):
        raise ValueError(f"Nest lengths differ: {len(tree)} vs {len(r)}")
    children = [_map(fn, xs[0], xs[1:], is_leaf, sort_keys)
                for xs in zip(tree, *rest)]
    if hasattr(tree, "_fields"):
      return type(tree)(*children)
    return type(tree)(children)
  if isinstance(tree, dict):
    for r in rest:
      if set(r) != set(tree):
        raise ValueError(f"Nest keys differ: {sorted(tree)} vs {sorted(r)}")
    keys = sorted(tree) if sort_keys else list(tree)
    values = {k: _map(fn, tree[k], [r[k] for r in rest], is_leaf, sort_keys)
              for k in keys}
    return {k: values[k] for k in tree}
  return fn(tree, *rest)


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
  """`fn` over the leaves of `tree` (and the matching leaves of `rest`)."""
  return _map(fn, tree, rest, is_leaf, sort_keys=False)


def tree_map_sorted(fn: Callable, tree, *rest,
                    is_leaf: Optional[Callable] = None):
  """`tree_map` calling `fn` in ``jax.tree_util``'s leaf order: a dict's
  children in sorted-key order. Each dict keeps its own key order."""
  return _map(fn, tree, rest, is_leaf, sort_keys=True)


def flatten(tree, is_leaf: Optional[Callable] = None) -> List[Any]:
  """Leaves of `tree` in traversal order."""
  leaves = []
  tree_map(leaves.append, tree, is_leaf=is_leaf)
  return leaves


def flatten_sorted(tree, is_leaf: Optional[Callable] = None) -> List[Any]:
  """Leaves of `tree` in ``jax.tree_util.tree_leaves``'s order."""
  leaves = []
  tree_map_sorted(leaves.append, tree, is_leaf=is_leaf)
  return leaves


def unflatten_sorted(structure, leaves,
                     is_leaf: Optional[Callable] = None):
  """The nest of `structure`'s shape holding `leaves`, which are in
  `flatten_sorted`'s order (``jax.tree_util.tree_unflatten``)."""
  it = iter(leaves)
  return tree_map_sorted(lambda _: next(it), structure, is_leaf=is_leaf)


def where(condition: torch.Tensor, true_nest, false_nest):
  """Leaf-wise select; `condition` broadcasts over each leaf's inner dims."""

  def _where(t, f):
    extra = t.dim() - condition.dim()
    cond = condition.reshape(tuple(condition.shape) + (1,) * extra)
    return torch.where(cond, t, f)

  return tree_map(_where, true_nest, false_nest)


def stack_nested_tensors(nests, dim: int = 0):
  """Stack a list of nests along a new dim."""
  return tree_map(lambda *xs: torch.stack(xs, dim=dim), *nests)


def stack_nested_arrays(nests, axis: int = 0):
  """Stack a list of numpy nests along a new axis."""
  return tree_map(lambda *xs: np.stack(xs, axis=axis), *nests)


def unstack_nested_arrays(nest):
  """A ``[B, ...]`` numpy nest as a list of B unbatched nests."""
  leaves = flatten(nest)
  if not leaves:
    return []
  return [tree_map(lambda x: np.asarray(x)[i], nest)
          for i in range(np.shape(leaves[0])[0])]


def _expand0(x):
  return x.unsqueeze(0) if isinstance(x, torch.Tensor) else np.expand_dims(
      x, 0)


def _squeeze0(x):
  return x.squeeze(0) if isinstance(x, torch.Tensor) else np.squeeze(x, 0)


def batch_nested_array(nest):
  """Add a leading batch dim of 1 to every leaf."""
  return tree_map(_expand0, nest)


def unbatch_nested_array(nest):
  """Remove the leading batch dim of 1 from every leaf."""
  return tree_map(_squeeze0, nest)


def tile_batch(nest, multiplier: int):
  """Repeat each leaf's rows `multiplier` times along dim 0, each row's
  copies together (``jnp.repeat``)."""

  def _tile(t):
    if isinstance(t, torch.Tensor):
      return torch.repeat_interleave(t, multiplier, dim=0)
    return np.repeat(t, multiplier, axis=0)

  return tree_map(_tile, nest)


def select_batch(nest, index):
  """``leaf[index]`` along dim 0 of every leaf."""
  return tree_map(lambda x: x[index], nest)


def prune_extra_keys(narrow, wide):
  """`wide` without the dict keys that `narrow` lacks."""
  if isinstance(narrow, dict) and isinstance(wide, dict):
    return type(wide)(
        (k, prune_extra_keys(narrow[k], wide[k])) for k in narrow if k in wide)
  if isinstance(narrow, (list, tuple)) and isinstance(wide, (list, tuple)) \
      and not hasattr(narrow, "_fields"):
    if len(narrow) != len(wide):
      return wide
    pruned = [prune_extra_keys(n, w) for n, w in zip(narrow, wide)]
    return type(wide)(pruned) if not hasattr(wide, "_fields") else wide
  return wide


def _is_spec(x) -> bool:
  return hasattr(x, "shape") and hasattr(x, "dtype") and hasattr(
      x, "check_array")


def get_outer_rank(nest, specs) -> int:
  """The number of leading batch dims shared by every leaf; raises when
  the leaves disagree or a leaf does not end with its spec's shape."""
  leaves = flatten_sorted(nest)
  spec_leaves = flatten_sorted(specs, is_leaf=_is_spec)
  if len(leaves) != len(spec_leaves):
    raise ValueError(f"nest / spec leaf count mismatch: {len(leaves)} vs "
                     f"{len(spec_leaves)}")
  outer_rank = None
  for leaf, spec in zip(leaves, spec_leaves):
    inner, shape = tuple(spec.shape), tuple(np.shape(leaf))
    if len(shape) < len(inner) or (
        inner and shape[len(shape) - len(inner):] != inner):
      raise ValueError(f"Leaf shape {shape} does not end with spec shape "
                       f"{inner}")
    rank = len(shape) - len(inner)
    if outer_rank is not None and rank != outer_rank:
      raise ValueError(
          f"Inconsistent outer ranks across leaves: {outer_rank} vs {rank}")
    outer_rank = rank
  return 0 if outer_rank is None else outer_rank


def get_outer_shape(nest, specs) -> tuple:
  """The leading batch shape shared by every leaf; raises when the leaves
  agree on the outer rank but not on its sizes."""
  rank = get_outer_rank(nest, specs)
  leaves = flatten(nest)
  if not leaves:
    return ()
  outer = tuple(np.shape(leaves[0]))[:rank]
  for leaf in leaves[1:]:
    if tuple(np.shape(leaf))[:rank] != outer:
      raise ValueError(f"Inconsistent outer dims across nest leaves: {outer} "
                       f"vs {tuple(np.shape(leaf))[:rank]}")
  return outer
