"""Policy export and import.

Port of ``agents_tpu/policies/policy_saver.py``. An export directory
holds the policy's parameters (``params.pt``: ``{leaf path: CPU tensor}``
written with `torch.save`, loadable with ``weights_only=True``, where the
JAX package writes an orbax checkpoint), a JSON manifest of specs, train
step, metadata and the policy's config (`policies.registry`), and the
`torch.export` artifact of its ``action`` (`policies/torch_export.py`),
which acts in a process that imports only numpy and torch.

`load_policy(dir)` with no policy object rebuilds the policy from the
manifest's ``policy_config`` and returns a `SavedPolicy`, which acts on
numpy time steps through the port's `JittedPyPolicy`. Every file is
published by a write to a unique tmp file and a rename, because actors
poll these directories live. Reading a JAX orbax export is out of scope:
the port cannot read orbax without JAX.
"""
from __future__ import annotations

import copy
import io
import json
import os
from typing import Optional

import numpy as np
import torch

from agents_tpu_torch.policies import torch_export
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.device import resolve_device

PARAMS_FILE = "params.pt"
MANIFEST = "policy_manifest.json"


def _spec_to_json(spec):
  def leaf(s):
    d = {"shape": list(s.shape), "dtype": np.dtype(s.dtype).name,
         "name": s.name}
    if isinstance(s, array_spec.BoundedArraySpec):
      d["minimum"] = np.asarray(s.minimum).tolist()
      d["maximum"] = np.asarray(s.maximum).tolist()
    return d

  return nest_utils.tree_map(leaf, spec, is_leaf=array_spec._is_spec)


def _spec_from_json(d):
  if isinstance(d, dict) and "dtype" in d and "shape" in d:
    if "minimum" in d:
      return array_spec.BoundedArraySpec(
          tuple(d["shape"]), d["dtype"], np.asarray(d["minimum"]),
          np.asarray(d["maximum"]), d.get("name"))
    return array_spec.ArraySpec(tuple(d["shape"]), d["dtype"], d.get("name"))
  if isinstance(d, dict):
    return {k: _spec_from_json(v) for k, v in d.items()}
  if isinstance(d, list):
    return [_spec_from_json(v) for v in d]
  return d


def write_params(export_dir: str, params):
  """Atomically write ``params.pt``: every tensor of the params nest by
  its leaf path (`torch_export.param_leaves`), on the CPU."""
  flat = {path: t.detach().cpu().clone()
          for path, t in torch_export.param_leaves(params)}
  buf = io.BytesIO()
  torch.save(flat, buf)
  torch_export.atomic_publish(
      os.path.join(export_dir, PARAMS_FILE),
      lambda f: f.write(buf.getvalue()), mode="wb")


def load_params(params, export_dir: str):
  """Copy ``params.pt`` into the tensors of the params nest `params` in
  place (on their devices) and return it; leaf paths and shapes must
  match."""
  saved = torch.load(os.path.join(export_dir, PARAMS_FILE),
                     map_location="cpu", weights_only=True)
  leaves = torch_export.param_leaves(params)
  if sorted(saved) != sorted(path for path, _ in leaves):
    raise ValueError(f"{export_dir}: saved leaves {sorted(saved)} differ "
                     f"from the template's {[p for p, _ in leaves]}")
  with torch.no_grad():
    for path, t in leaves:
      if tuple(saved[path].shape) != tuple(t.shape):
        raise ValueError(f"{path}: saved {tuple(saved[path].shape)}, "
                         f"template {tuple(t.shape)}")
      t.copy_(saved[path])
  return params


def default_platforms() -> tuple:
  """``cpu`` always, ``cuda`` when a card is present."""
  return ("cpu", "cuda") if torch.cuda.is_available() else ("cpu",)


class PolicySaver:
  """Saves (params, specs, train_step, metadata) of a policy, and its
  `torch.export` artifact for `default_platforms()`."""

  def __init__(self, policy, train_step: int = 0,
               metadata: Optional[dict] = None):
    self.policy = policy
    self.train_step = train_step
    self.metadata = metadata or {}
    self.platforms = default_platforms()
    self._saved_dirs = set()

  def _export(self, export_dir, params) -> str:
    """Export batch-polymorphic, else pinned to batch 1 (a trace that
    rejects a symbolic batch). A policy that exports nowhere records why;
    one that exports on the CPU but not on the card raises, so no
    artifact hides the card."""
    try:
      torch_export.export_action(self.policy, params, export_dir,
                                 platforms=self.platforms)
      return "batch-polymorphic"
    except Exception:  # noqa: BLE001  (a symbolic-batch-hostile trace)
      pass
    try:
      torch_export.export_action(self.policy, params, export_dir,
                                 batch_size=1, platforms=self.platforms)
      return "batch=1"
    except torch_export.PlatformExportError:
      raise
    except Exception as e:  # noqa: BLE001  (not exportable: host code...)
      return f"unavailable: {type(e).__name__}"

  def save(self, export_dir: str, params):
    """Write the whole artifact: params, manifest and the `torch.export`
    programs of ``action``."""
    from agents_tpu_torch.policies.registry import policy_config
    export_dir = os.path.abspath(export_dir)
    os.makedirs(export_dir, exist_ok=True)
    self._saved_dirs.add(export_dir)
    write_params(export_dir, params)
    export_info = self._export(export_dir, params)
    tss = torch_export.full_time_step_spec(self.policy)
    manifest = {
        "time_step_spec": {
            "observation": _spec_to_json(tss.observation),
            "reward": _spec_to_json(tss.reward),
        },
        "action_spec": _spec_to_json(self.policy.action_spec),
        "train_step": int(self.train_step),
        "metadata": self.metadata,
        "torch_export": export_info,
        # The policy and network architecture as a config, or null when
        # the policy holds unserializable pieces: then load_policy needs
        # the policy object.
        "policy_config": policy_config(self.policy),
    }
    torch_export.atomic_json_dump(manifest,
                                  os.path.join(export_dir, MANIFEST))

  def save_checkpoint(self, export_dir: str, params):
    """Params-only refresh: ``params.pt``, the programs' flat-params npz
    (no re-export: the programs take params as inputs) and the manifest's
    train step, each written atomically."""
    export_dir = os.path.abspath(export_dir)
    write_params(export_dir, params)
    if os.path.exists(os.path.join(export_dir, torch_export.MANIFEST)):
      torch_export.write_params_npz(export_dir, params)
    manifest_path = os.path.join(export_dir, MANIFEST)
    if os.path.exists(manifest_path):
      with open(manifest_path) as f:
        manifest = json.load(f)
      manifest["train_step"] = int(self.train_step)
      torch_export.atomic_json_dump(manifest, manifest_path)

  def publish(self, export_dir: str, params, train_step: int):
    """Publish `params` at `train_step` during training: the first publish
    to a directory by this saver writes the whole artifact (a restarted
    job with another network must not refresh params under a stale
    program and manifest); later ones refresh the params only, so
    training never re-traces."""
    self.train_step = train_step
    if os.path.abspath(export_dir) in self._saved_dirs:
      self.save_checkpoint(export_dir, params)
    else:
      self.save(export_dir, params)


class SavedPolicy:
  """A loaded policy: numpy time steps in, numpy actions out."""

  def __init__(self, policy, params, train_step: int, metadata: dict,
               export_dir: str, device="cuda"):
    from agents_tpu_torch.policies.jitted_py_policy import JittedPyPolicy
    self.policy = policy
    self.params = params
    self.train_step = train_step
    self.metadata = metadata
    self._export_dir = export_dir
    self._py = JittedPyPolicy(policy, params, device=device)

  def action(self, time_step, state=()):
    return self._py.action(time_step, state)

  def init_state(self, batch_size=None):
    return self._py.init_state(batch_size)

  def get_train_step(self):
    return self.train_step

  def get_metadata(self):
    return self.metadata

  def update_from_checkpoint(self, export_dir: Optional[str] = None):
    """Re-read the params (in place) and the train step."""
    export_dir = os.path.abspath(export_dir or self._export_dir)
    load_params(self.params, export_dir)
    self.train_step = load_manifest(export_dir)["train_step"]
    self._py.update_params(self.params)


def load_manifest(export_dir: str) -> dict:
  with open(os.path.join(export_dir, MANIFEST)) as f:
    return json.load(f)


def load_policy(export_dir: str, policy=None, params_template=None,
                device="cuda") -> SavedPolicy:
  """Load an exported policy onto `device`.

  Self-contained path: with no `policy`, the policy is rebuilt from the
  manifest's ``policy_config`` (networks, wrapper stack, specs) and its
  network takes the saved params; a fresh process needs only the export
  directory. Explicit path: pass `policy` (and `params_template`, a
  params nest of the same structure, filled in place; a copy of the
  policy's network when None) for an artifact whose manifest has no
  ``policy_config``.
  """
  from agents_tpu_torch.policies.registry import build_policy, policy_network
  from agents_tpu_torch.trajectories import time_step as ts
  device = resolve_device(device)
  export_dir = os.path.abspath(export_dir)
  manifest = load_manifest(export_dir)
  if policy is None:
    cfg = manifest.get("policy_config")
    if cfg is None:
      raise ValueError(
          f"{export_dir} was saved without a policy_config (the policy "
          "held unserializable pieces); pass the policy object to "
          "load_policy explicitly.")
    tss = ts.time_step_spec(
        _spec_from_json(manifest["time_step_spec"]["observation"]),
        _spec_from_json(manifest["time_step_spec"]["reward"]))
    policy = build_policy(cfg, tss, _spec_from_json(manifest["action_spec"]),
                          device)
    params = policy_network(policy)
  elif params_template is None:
    params = copy.deepcopy(policy_network(policy)).to(device)
  else:
    params = params_template
  load_params(params, export_dir)
  return SavedPolicy(policy, params, manifest["train_step"],
                     manifest.get("metadata", {}), export_dir, device)
