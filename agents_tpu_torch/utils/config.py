"""Dataclass configs with command-line overrides and a JSON round trip.

Port of ``agents_tpu/utils/config.py``: experiment configs are plain
frozen dataclasses, overridden from the command line with
``--cfg.field=value`` (dotted paths for nested dataclasses), and saved as
JSON for reproducibility.

Values convert as in the JAX package (bools from "1"/"true"/"yes",
``Tuple[int, ...]``-typed fields from "64,64", anything else through
JSON), with one addition: a field annotated with a bare ``tuple`` takes
the layout of its current value, so ``--cfg.fc_layer_params=32,16`` gives
``(32, 16)`` and a tuple of tuples is written ``32x8x4,64x4x2`` (the JAX
package would read these through JSON and fail).
"""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import Optional, Sequence, TypeVar

T = TypeVar("T")

_BASIC = {"int": int, "float": float, "str": str, "bool": bool}


def _convert(value: str, target_type, current=None):
  if target_type is bool:
    return value.lower() in ("1", "true", "yes")
  if target_type in (int, float, str):
    return target_type(value)
  if target_type is tuple and isinstance(current, tuple):
    if current and isinstance(current[0], tuple):
      return tuple(tuple(int(v) for v in part.split("x"))
                   for part in value.split(",") if part)
    inner = type(current[0]) if current else int
    return tuple(inner(v) for v in value.split(",") if v)
  origin = getattr(target_type, "__origin__", None)
  if origin in (tuple, list):
    inner = target_type.__args__[0]
    out = [_convert(v, inner) for v in value.split(",") if v]
    return tuple(out) if origin is tuple else out
  return json.loads(value)


def apply_overrides(cfg: T, overrides: Sequence[str], prefix="cfg") -> T:
  """Apply ``["--cfg.a.b=3", ...]`` to a (possibly nested) dataclass;
  other arguments are ignored."""
  for ov in overrides:
    if not ov.startswith("--"):
      continue
    body = ov[2:]
    if "=" not in body:
      continue
    path, value = body.split("=", 1)
    parts = path.split(".")
    if parts[0] == prefix:
      parts = parts[1:]
    if not parts:
      continue
    cfg = _set_path(cfg, parts, value)
  return cfg


def _set_path(cfg, parts, value):
  field_name = parts[0]
  if not dataclasses.is_dataclass(cfg):
    raise TypeError(f"Cannot override into non-dataclass: {cfg}")
  fields = {f.name: f for f in dataclasses.fields(cfg)}
  if field_name not in fields:
    raise KeyError(
        f"Unknown config field '{field_name}'; valid: {sorted(fields)}")
  current = getattr(cfg, field_name)
  if len(parts) == 1:
    ftype = fields[field_name].type
    if isinstance(ftype, str):
      # `from __future__ import annotations`: resolve the basic names.
      ftype = _BASIC.get(ftype, type(current) if current is not None
                         else str)
    if dataclasses.is_dataclass(current):
      ftype = type(current)
    new_value = _convert(value, ftype, current)
  else:
    new_value = _set_path(current, parts[1:], value)
  return dataclasses.replace(cfg, **{field_name: new_value})


def parse_flags(cfg: T, argv: Optional[Sequence[str]] = None,
                prefix="cfg") -> T:
  argv = sys.argv[1:] if argv is None else argv
  return apply_overrides(cfg, argv, prefix)


def to_json(cfg) -> str:
  return json.dumps(dataclasses.asdict(cfg), indent=2, default=str)


def save(cfg, path: str):
  with open(path, "w") as f:
    f.write(to_json(cfg))
