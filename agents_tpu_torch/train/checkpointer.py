"""Checkpoint and restore of a whole loop state with `torch.save`.

Port of ``agents_tpu/train/checkpointer.py`` (:17-62): the same
`Checkpointer` methods, keeping the newest `max_to_keep` steps, and
`initialize_or_restore` returning the template unchanged when the
directory holds no checkpoint. The JAX package hands a pytree to orbax;
the port's loop states hold live objects, so one generic walk
(`capture`, `restore_into`) turns a state into a nest of plain dicts,
lists, CPU tensors and numbers, and writes such a nest back into a
template state built the same way (a fresh loop from the same seed):

  - a tensor is saved on the CPU and restored by ``copy_`` into the
    template's tensor, on the template's device; a template tensor whose
    storage an earlier leaf already took (CartPole's observation is its
    physics state at reset) gets a tensor of its own instead;
  - an object with ``state_dict`` / ``load_state_dict`` (an `nn.Module`,
    a target network, a `torch.optim.Optimizer` with Adam's step counts,
    a learning-rate scheduler) goes through them, so a restored
    optimizer keeps its references to the live parameters;
  - Python ints, floats, bools and strings (the replay count, train
    steps) are kept as values;
  - a `Draws` keeps its generator's ``get_state()`` (a CPU ByteTensor,
    also for a generator on the card) and restores it with ``set_state``;
  - dataclasses (the loop, driver, agent, replay, metric and normalizer
    states), tuples, lists and dicts are walked field by field; a static
    dataclass field comes from the template.

`ReplayDraws` and `RecordingDraws` are not saved: their queues and records
belong to a test's replay of another run, so `capture` raises `TypeError`
for them, as for any object it does not know.

A checkpoint file holds ``{"step": int, "state": nest}`` and loads with
``torch.load(..., weights_only=True)``. `save` writes a temporary file,
syncs it and renames it over the step's name, so a save that is killed
leaves the checkpoints before it intact.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, List, Optional

import torch

from agents_tpu_torch.utils.draws import Draws

_NAME = re.compile(r"^(\d+)\.pt$")


def _has_state_dict(x) -> bool:
  return hasattr(x, "state_dict") and hasattr(x, "load_state_dict")


def _to_cpu(nest):
  """`nest` (a state dict) with every tensor detached on the CPU."""
  if isinstance(nest, torch.Tensor):
    return nest.detach().cpu()
  if isinstance(nest, dict):
    return type(nest)((k, _to_cpu(v)) for k, v in nest.items())
  if isinstance(nest, (list, tuple)):
    return type(nest)(_to_cpu(v) for v in nest)
  return nest


def _children(x):
  """(name, value) of the nest children of a dataclass: its non-static
  fields."""
  return [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)
          if not f.metadata.get("static")]


def capture(state, path: str = "state") -> Any:
  """`state` as a nest of plain dicts, lists, CPU tensors and numbers."""
  if isinstance(state, torch.Tensor):
    return state.detach().cpu()
  if type(state) is Draws:
    return {"generator_state": state.generator.get_state()}
  if _has_state_dict(state):
    return _to_cpu(state.state_dict())
  if dataclasses.is_dataclass(state) and not isinstance(state, type):
    return {name: capture(value, f"{path}.{name}")
            for name, value in _children(state)}
  if isinstance(state, (tuple, list)):
    return [capture(v, f"{path}[{i}]") for i, v in enumerate(state)]
  if isinstance(state, dict):
    return {k: capture(v, f"{path}[{k!r}]") for k, v in state.items()}
  if state is None or isinstance(state, (bool, int, float, str)):
    return state
  raise TypeError(f"cannot checkpoint {path}: a {type(state).__name__} "
                  "(ReplayDraws and RecordingDraws replay another run's "
                  "draws and are not saved)")


def restore_into(template, saved, path: str = "state", _taken=None):
  """`template` with `saved` (a `capture` of a state built the same way)
  written into it; tensors, modules, optimizers and draw sources are
  updated in place and returned."""
  taken = set() if _taken is None else _taken
  if isinstance(template, torch.Tensor):
    if (not isinstance(saved, torch.Tensor) or saved.shape != template.shape
        or saved.dtype != template.dtype):
      raise ValueError(f"{path}: saved {_describe(saved)}, template "
                       f"{_describe(template)}")
    if template.numel() == 0:
      return template
    storage = template.untyped_storage().data_ptr()
    if storage in taken:
      return saved.to(template.device, copy=True)
    taken.add(storage)
    with torch.no_grad():
      template.copy_(saved)
    return template
  if type(template) is Draws:
    template.generator.set_state(saved["generator_state"])
    return template
  if _has_state_dict(template):
    template.load_state_dict(saved)
    return template
  if dataclasses.is_dataclass(template) and not isinstance(template, type):
    return dataclasses.replace(template, **{
        name: restore_into(value, saved[name], f"{path}.{name}", taken)
        for name, value in _children(template)})
  if isinstance(template, (tuple, list)):
    if len(saved) != len(template):
      raise ValueError(f"{path}: saved {len(saved)} items, template "
                       f"{len(template)}")
    items = [restore_into(t, s, f"{path}[{i}]", taken)
             for i, (t, s) in enumerate(zip(template, saved))]
    if hasattr(template, "_fields"):
      return type(template)(*items)
    return type(template)(items)
  if isinstance(template, dict):
    if set(saved) != set(template):
      raise ValueError(f"{path}: saved keys {sorted(saved)}, template "
                       f"{sorted(template)}")
    return {k: restore_into(v, saved[k], f"{path}[{k!r}]", taken)
            for k, v in template.items()}
  if template is None or isinstance(template, (bool, int, float, str)):
    if type(saved) is not type(template):
      raise ValueError(f"{path}: saved {saved!r}, template {template!r}")
    return saved
  raise TypeError(f"cannot restore {path}: a {type(template).__name__}")


def _describe(x) -> str:
  if isinstance(x, torch.Tensor):
    return f"{x.dtype} {tuple(x.shape)}"
  return type(x).__name__


class Checkpointer:
  """Keeps the newest `max_to_keep` checkpoints of a loop state.

  Each step is one file ``<ckpt_dir>/<step>.pt``. Saves are synchronous,
  so `wait` and `close` have nothing to wait for.
  """

  def __init__(self, ckpt_dir: str, max_to_keep: int = 3):
    self._dir = os.path.abspath(ckpt_dir)
    self._max_to_keep = int(max_to_keep)
    os.makedirs(self._dir, exist_ok=True)

  @property
  def directory(self) -> str:
    return self._dir

  def _path(self, step: int) -> str:
    return os.path.join(self._dir, f"{int(step)}.pt")

  def all_steps(self) -> List[int]:
    return sorted(int(m.group(1)) for name in os.listdir(self._dir)
                  if (m := _NAME.match(name)))

  def save(self, step: int, state, force: bool = False) -> bool:
    """Write `state` as `step`; False (and nothing written) when `step` is
    already saved. Every call saves (there is no save-interval policy to
    override, so `force` changes nothing)."""
    del force
    step = int(step)
    if step in self.all_steps():
      return False
    payload = {"step": step, "state": capture(state)}
    tmp = os.path.join(self._dir, f".{step}.pt.tmp")
    with open(tmp, "wb") as f:
      torch.save(payload, f)
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, self._path(step))
    steps = self.all_steps()
    for old in steps[:max(len(steps) - self._max_to_keep, 0)]:
      os.remove(self._path(old))
    return True

  def wait(self):
    """Saves are synchronous: nothing is in flight."""

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

  def restore(self, state_template, step: Optional[int] = None):
    """`state_template` with the checkpoint of `step` (the newest when
    None) written into it; raises FileNotFoundError when there is none."""
    step = self.latest_step() if step is None else int(step)
    if step is None or not os.path.exists(self._path(step)):
      raise FileNotFoundError(f"No checkpoint in {self._dir}"
                              + ("" if step is None else f" for step {step}"))
    payload = torch.load(self._path(step), map_location="cpu",
                         weights_only=True)
    return restore_into(state_template, payload["state"])

  def initialize_or_restore(self, state_template):
    """The newest checkpoint written into `state_template`, or the template
    unchanged when there is none."""
    if self.latest_step() is None:
      return state_template
    return self.restore(state_template)

  def close(self):
    """Nothing to release: no file stays open between calls."""
