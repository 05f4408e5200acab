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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch


def _is_dataclass_instance(x) -> bool:
  return dataclasses.is_dataclass(x) and not isinstance(x, type)


def static_field(**kwargs):
  """A dataclass field that is no child of the nest (``dataclasses.field``
  with metadata ``{"static": True}``)."""
  return dataclasses.field(metadata={"static": True}, **kwargs)


def _is_static(f: dataclasses.Field) -> bool:
  return bool(f.metadata.get("static"))


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
  """`fn` over the leaves of `tree` (and the matching leaves of `rest`)."""
  if is_leaf is not None and is_leaf(tree):
    return fn(tree, *rest)
  if tree is None:
    return None
  if _is_dataclass_instance(tree):
    return type(tree)(**{
        f.name: getattr(tree, f.name) if _is_static(f) else tree_map(
            fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest),
            is_leaf=is_leaf)
        for f in dataclasses.fields(tree)})
  if isinstance(tree, (tuple, list)):
    for r in rest:
      if len(r) != len(tree):
        raise ValueError(f"Nest lengths differ: {len(tree)} vs {len(r)}")
    children = [tree_map(fn, *xs, is_leaf=is_leaf) for xs in zip(tree, *rest)]
    if hasattr(tree, "_fields"):
      return type(tree)(*children)
    return type(tree)(children)
  if isinstance(tree, dict):
    for r in rest:
      if set(r) != set(tree):
        raise ValueError(f"Nest keys differ: {sorted(tree)} vs {sorted(r)}")
    return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
            for k, v in tree.items()}
  return fn(tree, *rest)


def flatten(tree, is_leaf: Optional[Callable] = None) -> List[Any]:
  """Leaves of `tree` in traversal order."""
  leaves = []
  tree_map(leaves.append, tree, is_leaf=is_leaf)
  return leaves


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
