"""Runtime-independent policy export via `torch.export`.

Port of ``agents_tpu/policies/stablehlo_export.py``: the JAX package
serializes its jitted ``action`` to StableHLO with ``jax.export``; the
port serializes the policy's ``action`` to a `torch.export`
ExportedProgram, one per platform (``cpu`` always, ``cuda`` when asked
for), batch-size polymorphic where the trace allows, plus

  - ``params_flat.npz``        parameter tensors in flattened order
                               (refreshable without re-export)
  - ``exported_manifest.json`` the calling convention: leaf paths, shapes
                               and dtypes of time step, state, action and
                               params, the programs per platform, and the
                               draw sites
  - ``loader.py``              a loader written INTO the artifact that
                               imports numpy and torch only, never
                               `agents_tpu_torch`.

Calling convention of each exported program (the JAX one, with the key
replaced by the draws it would have made):

  (flat_params, draw_inputs, flat_time_step, flat_state)
      -> (flat_action, flat_next_state)

``flat_time_step`` is (step_type, reward, discount, *observation leaves),
leaves in ``jax.tree_util``'s order (dict keys sorted). The parameters
are explicit inputs: each module of the params nest is called through
``torch.func.functional_call`` with graph inputs in place of its
parameters and buffers, so ``params_flat.npz`` swaps them.

Randomness: a `torch.Generator` cannot be a graph input. The policy is
first run with a draw source that logs every draw (kind, site, shape,
bounds); twice, at two batch sizes, to find each draw's batch dim. The
program then takes one input per logged draw and the policy draws from
those inputs (`utils.draws.InputDraws`). The manifest lists the sites;
the loader fills them from ``numpy.random.default_rng(key_data)``. A
greedy policy has no sites and ignores ``key_data``. By kind, a site's
input is:

  - uniform, randint, normal: the draw itself, of the site's shape;
  - gamma: ``[2R + 1, *shape]`` float32, R normals then R + 1 uniforms in
    [0, 1), which the program turns into standard-gamma variates by
    Marsaglia and Tsang's method in R rounds
    (`utils.draws.marsaglia_tsang_gamma`; R is the site's ``rounds``);
  - beta: ``[2, 2R + 1, *shape]``, two such inputs, and the variate
    ``x / (x + y)`` of their gammas;
  - permutation: ``[n]`` float64 uniform keys, whose argsort is the
    permutation.

So any stochastic policy exports, Bernoulli Thompson sampling's Beta
draws included, and an artifact stays a pure function of its inputs.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import tempfile
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import draws as draws_lib
from agents_tpu_torch.utils import nest_utils
from agents_tpu_torch.utils.draws import Draws, InputDraws

PARAMS_NPZ = "params_flat.npz"
MANIFEST = "exported_manifest.json"
LOADER = "loader.py"
EXAMPLE_BATCH = 3


def program_file(platform: str) -> str:
  return f"exported_action_{platform}.pt2"


def atomic_publish(path: str, write_fn, mode: str = "w"):
  """Write through a unique tmp file and a rename: pollers never read a
  torn file, and two overlapping exporters cannot truncate each other's
  half-written tmp; the last rename wins with a whole file."""
  fd, tmp = tempfile.mkstemp(
      dir=os.path.dirname(os.path.abspath(path)),
      prefix=os.path.basename(path) + ".", suffix=".tmp")
  try:
    with os.fdopen(fd, mode) as f:
      write_fn(f)
    os.replace(tmp, path)
  except BaseException:
    if os.path.exists(tmp):
      os.unlink(tmp)
    raise


def atomic_json_dump(obj, path: str):
  """Atomically publish JSON (actors poll the manifests live)."""
  atomic_publish(path, lambda f: json.dump(obj, f, indent=2))


def _is_spec(x) -> bool:
  return isinstance(x, array_spec.ArraySpec)


def _fields(params):
  """A dataclass instance's (name, value) pairs, else None."""
  if dataclasses.is_dataclass(params) and not isinstance(params, type):
    return [(f.name, getattr(params, f.name))
            for f in dataclasses.fields(params)]
  return None


def param_leaves(params, path: str = "") -> List[tuple]:
  """(path, tensor) of every tensor of a params nest, in a fixed order: a
  module's parameters then its buffers (``named_parameters``,
  ``named_buffers``), a dict's values by sorted key, a dataclass's fields
  in order (a Bernoulli Thompson sampling state), a tuple's or list's
  items in order, a tensor itself. Numbers are no leaves: they are
  constants of the program."""
  if isinstance(params, nn.Module):
    named = list(params.named_parameters()) + list(params.named_buffers())
    return [(f"{path}{name}", t) for name, t in named]
  if isinstance(params, torch.Tensor):
    return [(path.rstrip("/") or "tensor", params)]
  if _fields(params) is not None:
    return [leaf for k, v in _fields(params)
            for leaf in param_leaves(v, f"{path}{k}/")]
  if isinstance(params, dict):
    return [leaf for k in sorted(params)
            for leaf in param_leaves(params[k], f"{path}{k}/")]
  if isinstance(params, (tuple, list)):
    return [leaf for i, v in enumerate(params)
            for leaf in param_leaves(v, f"{path}{i}/")]
  return []


def _bind(params, tensors):
  """`params` with each module replaced by a call of it through
  ``torch.func.functional_call`` with, and each tensor replaced by, the
  next of `tensors` (an iterator in `param_leaves`' order)."""
  if isinstance(params, nn.Module):
    bound = {name: next(tensors) for name, _ in param_leaves(params)}
    return lambda *args, **kwargs: torch.func.functional_call(
        params, bound, args, kwargs)
  if isinstance(params, torch.Tensor):
    return next(tensors)
  if _fields(params) is not None:
    return type(params)(**{k: _bind(v, tensors) for k, v in _fields(params)})
  if isinstance(params, dict):
    bound = {k: _bind(params[k], tensors) for k in sorted(params)}
    return {k: bound[k] for k in params}
  if isinstance(params, (tuple, list)):
    return type(params)(_bind(v, tensors) for v in params)
  return params


def _params_on(params, device: torch.device):
  """`params` with every module and tensor on `device` (deep copies of
  those that live elsewhere)."""
  if isinstance(params, nn.Module):
    leaves = param_leaves(params)
    if not leaves or leaves[0][1].device == device:
      return params
    return copy.deepcopy(params).to(device)
  if isinstance(params, torch.Tensor):
    return params.detach().to(device)
  if _fields(params) is not None:
    return type(params)(**{k: _params_on(v, device)
                           for k, v in _fields(params)})
  if isinstance(params, dict):
    return {k: _params_on(v, device) for k, v in params.items()}
  if isinstance(params, (tuple, list)):
    return type(params)(_params_on(v, device) for v in params)
  return params


def full_time_step_spec(policy):
  tss = policy.time_step_spec
  if isinstance(tss, ts.TimeStep):
    return tss
  # A policy built with an observation-spec-only time_step_spec.
  return ts.time_step_spec(tss)


def _numpy_dtype(dtype: torch.dtype) -> str:
  return torch.empty((), dtype=dtype).numpy().dtype.name


class _DrawLog:
  """A draw source that logs each draw (kind, site, shape, dtype, bounds)
  and returns a real draw from `source`."""

  def __init__(self, source):
    self.source = source
    self.device = source.device
    self.calls = []

  def uniform(self, site, shape, low=0.0, high=1.0, dtype=torch.float32):
    self.calls.append(("uniform", site, tuple(shape), dtype, float(low),
                       float(high)))
    return self.source.uniform(site, shape, low, high, dtype)

  def randint(self, site, shape, low, high, dtype=torch.int64):
    self.calls.append(("randint", site, tuple(shape), dtype, int(low),
                       int(high)))
    return self.source.randint(site, shape, low, high, dtype)

  def normal(self, site, shape, dtype=torch.float32):
    self.calls.append(("normal", site, tuple(shape), dtype, None, None))
    return self.source.normal(site, shape, dtype)

  def permutation(self, site, n):
    self.calls.append(("permutation", site, (int(n),), torch.float64, None,
                       None))
    return self.source.permutation(site, n)

  def gamma(self, site, concentration):
    self.calls.append(("gamma", site, tuple(concentration.shape),
                       concentration.dtype, None, None))
    return self.source.gamma(site, concentration)

  def beta(self, site, concentration1, concentration0):
    self.calls.append(("beta", site, tuple(concentration1.shape),
                       concentration1.dtype, None, None))
    return self.source.beta(site, concentration1, concentration0)


def _leading(site: dict) -> tuple:
  """The dims a site's input has before the draw's own shape."""
  if site["kind"] == "gamma":
    return draws_lib.gamma_input_shape((), site["rounds"])
  if site["kind"] == "beta":
    return (2,) + draws_lib.gamma_input_shape((), site["rounds"])
  return ()


def _input_shape(site: dict, batch: int) -> tuple:
  """The shape of a site's program input at `batch`."""
  return _leading(site) + tuple(batch if d is None else d
                                for d in site["shape"])


def _example_inputs(tss, state_spec, batch: int, device):
  """Zero time-step leaves (MID steps) and zero state leaves at `batch`."""
  ts_leaves = []
  for i, s in enumerate(nest_utils.flatten_sorted(tss, is_leaf=_is_spec)):
    x = torch.zeros((batch,) + tuple(s.shape),
                    dtype=array_spec.torch_dtype(s.dtype), device=device)
    ts_leaves.append(x + ts.StepType.MID if i == 0 else x)
  state_leaves = [
      torch.zeros((batch,) + tuple(s.shape),
                  dtype=array_spec.torch_dtype(s.dtype), device=device)
      for s in nest_utils.flatten_sorted(state_spec, is_leaf=_is_spec)]
  return ts_leaves, state_leaves


class _ActionProgram(nn.Module):
  """The function that is exported:
  (flat_params, draw_inputs, flat_time_step, flat_state)
      -> (flat_action, flat_next_state)."""

  def __init__(self, policy, params, sites, device):
    super().__init__()
    self._policy = policy
    self._params = [params]   # a list: not registered as a submodule
    self._sites = sites
    self._device = device
    self._tss = full_time_step_spec(policy)

  def forward(self, flat_params, draw_inputs, flat_ts, flat_state):
    policy = self._policy
    params = _bind(self._params[0], iter(flat_params))
    time_step = nest_utils.unflatten_sorted(self._tss, flat_ts,
                                            is_leaf=_is_spec)
    state = (nest_utils.unflatten_sorted(policy.state_spec, flat_state,
                                         is_leaf=_is_spec)
             if flat_state else ())
    draws = InputDraws(self._sites, draw_inputs, self._device)
    step = policy.action(params, time_step, state, draws)
    return (list(nest_utils.flatten_sorted(step.action)),
            list(nest_utils.flatten_sorted(step.state)))


def _log_draws(policy, params, tss, batch, device):
  ts_leaves, state_leaves = _example_inputs(tss, policy.state_spec, batch,
                                            device)
  log = _DrawLog(Draws(0, device))
  time_step = nest_utils.unflatten_sorted(tss, ts_leaves, is_leaf=_is_spec)
  state = (nest_utils.unflatten_sorted(policy.state_spec, state_leaves,
                                       is_leaf=_is_spec)
           if state_leaves else ())
  with torch.no_grad():
    policy.action(params, time_step, state, log)
  return log.calls


def draw_sites(policy, params, device) -> List[dict]:
  """The draws `policy.action` makes, in order: kind, site, shape with
  None at the batch dim, dtype and bounds."""
  tss = full_time_step_spec(policy)
  a = _log_draws(policy, params, tss, EXAMPLE_BATCH - 1, device)
  b = _log_draws(policy, params, tss, EXAMPLE_BATCH, device)
  if [c[:2] for c in a] != [c[:2] for c in b]:
    raise ValueError("the policy draws at different sites for different "
                     "batch sizes; it cannot be exported")
  sites = []
  for (kind, site, shape_a, dtype, low, high), call_b in zip(a, b):
    shape_b = call_b[2]
    if len(shape_a) != len(shape_b):
      raise ValueError(f"draw site {site!r} changes rank with the batch")
    batch_dims = [i for i, (x, y) in enumerate(zip(shape_a, shape_b))
                  if x != y]
    if len(batch_dims) > 1:
      raise ValueError(f"draw site {site!r} has more than one batch dim")
    entry = {
        "kind": kind, "site": site,
        "shape": [None if i in batch_dims else d
                  for i, d in enumerate(shape_b)],
        "dtype": _numpy_dtype(dtype), "low": low, "high": high}
    if kind in ("gamma", "beta"):
      entry["rounds"] = draws_lib.GAMMA_ROUNDS
    sites.append(entry)
  return sites


def _draw_examples(sites, batch, device):
  """Example draw inputs: the low bound of a randint, a uniform's middle
  for the transformed kinds (a gamma's log of a uniform needs it
  positive), zeros otherwise."""
  out = []
  for s in sites:
    shape = _input_shape(s, batch)
    dtype = array_spec.torch_dtype(s["dtype"])
    fill = {"randint": s["low"], "gamma": 0.5, "beta": 0.5,
            "permutation": 0.5}.get(s["kind"], 0)
    out.append(torch.full(shape, fill, dtype=dtype, device=device))
  return out


def _export_one(policy, params, sites, device, batch_size):
  """The ExportedProgram of `policy.action` on `device`."""
  params = _params_on(params, device)
  tss = full_time_step_spec(policy)
  batch = EXAMPLE_BATCH if batch_size is None else int(batch_size)
  ts_leaves, state_leaves = _example_inputs(tss, policy.state_spec, batch,
                                            device)
  flat_params = [t.detach() for _, t in param_leaves(params)]
  draws = _draw_examples(sites, batch, device)
  args = (flat_params, draws, ts_leaves, state_leaves)
  dynamic_shapes = None
  if batch_size is None:
    b = torch.export.Dim("b", min=1)
    dynamic_shapes = (
        [None] * len(flat_params),
        [{s["shape"].index(None) + len(_leading(s)): b}
         if None in s["shape"] else None for s in sites],
        [{0: b}] * len(ts_leaves), [{0: b}] * len(state_leaves))
  program = _ActionProgram(policy, params, sites, device)
  with torch.no_grad():
    return torch.export.export(program, args, dynamic_shapes=dynamic_shapes,
                               strict=False)


def write_params_npz(export_dir: str, params):
  """Atomically write the flat-params npz the programs consume: the single
  source of the ``p{i}`` / `param_leaves` order contract shared by
  `export_action` and `PolicySaver.save_checkpoint`'s refreshes, so a
  concurrent loader's `refresh_params` never sees a partial zip."""
  flat = [t.detach().cpu().numpy() for _, t in param_leaves(params)]
  atomic_publish(
      os.path.join(export_dir, PARAMS_NPZ),
      lambda f: np.savez(f, **{f"p{i}": x for i, x in enumerate(flat)}),
      mode="wb")


class PlatformExportError(RuntimeError):
  """The policy exported on the CPU but not on another platform."""


def export_action(policy, params, export_dir: str,
                  batch_size: Optional[int] = None,
                  platforms: Sequence[str] = ("cpu",)) -> dict:
  """Export ``policy.action`` to `export_dir` once per platform; returns
  the manifest.

  ``batch_size=None`` exports a symbolic leading dim (``Dim("b",
  min=1)``); an int pins it (the fallback for a policy whose trace
  rejects a symbolic batch). Every platform must export, or nothing of
  this call is published: a failure raises, as `PlatformExportError`
  when the CPU program exported and another did not.
  """
  platforms = list(platforms)
  leaves = param_leaves(params)
  device = leaves[0][1].device if leaves else torch.device(platforms[0])
  sites = draw_sites(policy, params, device)
  programs = {}
  for p in sorted(platforms, key=lambda p: p != "cpu"):
    try:
      programs[p] = _export_one(policy, params, sites, torch.device(p),
                                batch_size)
    except Exception as e:
      if "cpu" in programs:
        raise PlatformExportError(
            f"{type(policy).__name__} exports on the CPU but not on "
            f"{p}") from e
      raise
  os.makedirs(export_dir, exist_ok=True)
  for platform, program in programs.items():
    atomic_publish(os.path.join(export_dir, program_file(platform)),
                   lambda f, program=program: torch.export.save(program, f),
                   mode="wb")
  write_params_npz(export_dir, params)

  tss = full_time_step_spec(policy)
  ts_specs = nest_utils.flatten_sorted(tss, is_leaf=_is_spec)
  ts_names = ["step_type", "reward", "discount"]

  def describe(specs, names=()):
    names = list(names) + [None] * len(specs)
    return [{"shape": [None] + list(s.shape),
             "dtype": np.dtype(s.dtype).name, "name": names[i] or s.name}
            for i, s in enumerate(specs)]

  manifest = {
      "format": "torch.export ExportedProgram, calling convention "
                "(flat_params, draw_inputs, flat_time_step, flat_state) -> "
                "(flat_action, flat_next_state)",
      "platforms": platforms,
      "programs": {p: program_file(p) for p in platforms},
      "batch": "polymorphic" if batch_size is None else int(batch_size),
      "num_params_leaves": len(leaves),
      "params_leaf_paths": [path for path, _ in leaves],
      "params_leaves": [{"shape": list(t.shape),
                         "dtype": _numpy_dtype(t.dtype)} for _, t in leaves],
      "time_step_leaves": describe(ts_specs, ts_names),
      "state_leaves": describe(nest_utils.flatten_sorted(
          policy.state_spec, is_leaf=_is_spec)),
      "action_leaves": describe(nest_utils.flatten_sorted(
          policy.action_spec, is_leaf=_is_spec)),
      "draw_sites": sites,
  }
  atomic_json_dump(manifest, os.path.join(export_dir, MANIFEST))
  atomic_publish(os.path.join(export_dir, LOADER),
                 lambda f: f.write(LOADER_SRC))
  return manifest


# The loader written into every artifact: numpy and torch only, so any
# process (a serving binary, a bare interpreter) can run the policy.
LOADER_SRC = '''\
"""Self-contained loader for a torch.export policy artifact.

Dependencies: numpy and torch. It imports no framework. Usage:

    import loader
    policy = loader.ExportedPolicy(os.path.dirname(loader.__file__))
    action_leaves, next_state = policy.action(observation_leaves)

The program runs on "cuda" when the artifact has one and a card is
present, else on "cpu"; `platform=` picks one.

On "cuda" the program is replayed as one CUDA graph per input signature
(the shape and dtype of every time-step, state and draw leaf, and so the
batch size), on a stream of the policy's own. A signature's first call
runs the program op by op, which warms cuDNN, cuBLAS and the allocator;
its second captures the graph and replays it; every later call replays
it. A graph copies its inputs in from pinned host buffers, runs the
program and copies its outputs out to pinned host buffers, so a call
stages its arrays, launches the graph and waits once. A replay skips the
program's own checks of its inputs: a call whose signature has no graph
goes the op-by-op route. Calls are serialised by a lock, since they share
the graph's buffers; a capture takes in no other thread's work.
`refresh_params` copies new values into the tensors the graphs read, or
drops every graph where a leaf's shape or dtype changed. On "cpu" every
call runs the program op by op.

`span_hook` (None by default) may be set to a factory of named context
managers that takes ``request=True`` for the span of a whole call, such as
the port's `agents_tpu_torch.utils.profiling.annotate`: `action` then
opens "act.call" around each call, and inside it "act.prep"
(the time step and the draw inputs on the host), "act.upload" (the copies
to the program's device; on a replay, the staging into pinned buffers),
"act.program" (the program op by op, or the graph's launch, inside which
"act.replay" opens) and "act.fetch" (the copies back, where the host
waits for the device: on a replay, the one wait for the whole graph and
the copies out of the pinned buffers). Unset, each phase enters a null
context.
"""
import contextlib
import json
import os
import threading

import numpy as np
import torch

SPANS = ("act.call", "act.prep", "act.upload", "act.program", "act.replay",
         "act.fetch")


class ExportedPolicy:

  def __init__(self, artifact_dir, platform=None):
    self.span_hook = None
    self.dir = artifact_dir
    with open(os.path.join(artifact_dir, "exported_manifest.json")) as f:
      self.manifest = json.load(f)
    if platform is None:
      platform = ("cuda" if "cuda" in self.manifest["platforms"]
                  and torch.cuda.is_available() else "cpu")
    if platform not in self.manifest["platforms"]:
      raise ValueError(f"no {platform} program in {artifact_dir}: "
                       f"{self.manifest['platforms']}")
    self.platform = platform
    self.device = torch.device(platform)
    path = os.path.join(artifact_dir, self.manifest["programs"][platform])
    self._program = torch.export.load(path).module()
    # The card's route: the policy's stream, the output leaves (shape,
    # dtype) of each signature seen once and not yet captured, and each
    # captured signature's graph.
    self._stream = (torch.cuda.Stream(self.device)
                    if self.device.type == "cuda" else None)
    self._lock = threading.Lock()
    self._seen, self._graphs = {}, {}
    self.refresh_params()

  def refresh_params(self):
    """Re-read params_flat.npz (written atomically by the exporter).
    Where graphs are captured and every leaf keeps its shape and dtype,
    the new values are copied into the tensors the graphs read; otherwise
    the parameters are new tensors and every graph is dropped."""
    with np.load(os.path.join(self.dir, "params_flat.npz")) as z:
      new = [torch.from_numpy(z[f"p{i}"])
             for i in range(self.manifest["num_params_leaves"])]
    with self._lock:
      if self._graphs and all(
          p.shape == x.shape and p.dtype == x.dtype
          for p, x in zip(self.params, new)):
        for p, x in zip(self.params, new):
          p.copy_(x)
      else:
        self._seen.clear()
        self._graphs.clear()
        self.params = [x.to(self.device) for x in new]

  def initial_state(self, batch_size):
    return [np.zeros([batch_size] + d["shape"][1:], d["dtype"])
            for d in self.manifest["state_leaves"]]

  def make_time_step(self, observation_leaves, step_type=None):
    """The flat time step (step_type, reward, discount, *observation) in
    manifest order, defaulting to MID steps."""
    descs = self.manifest["time_step_leaves"]
    n_obs = len(observation_leaves)
    batch = np.shape(observation_leaves[0])[0]
    out = []
    for d in descs[:len(descs) - n_obs]:
      shape = [batch] + d["shape"][1:]
      if d.get("name") == "step_type":
        arr = np.full(shape, 1 if step_type is None else step_type,
                      d["dtype"])
      elif d.get("name") == "discount":
        arr = np.ones(shape, d["dtype"])
      else:
        arr = np.zeros(shape, d["dtype"])
      out.append(arr)
    return out + [np.asarray(o) for o in observation_leaves]

  def draw_inputs(self, batch_size, key_data):
    """One array per draw site of the manifest, drawn from
    numpy.random.default_rng(key_data)."""
    rng = np.random.default_rng(np.asarray(key_data, np.uint32).tolist())
    out = []
    for d in self.manifest["draw_sites"]:
      shape = [batch_size if s is None else s for s in d["shape"]]
      if d["kind"] == "uniform":
        x = d["low"] + rng.random(shape) * (d["high"] - d["low"])
      elif d["kind"] == "randint":
        x = rng.integers(d["low"], d["high"], size=shape)
      elif d["kind"] == "normal":
        x = rng.standard_normal(shape)
      elif d["kind"] == "permutation":
        x = rng.random(shape)
      else:
        x = [self._gamma_input(rng, shape, d["rounds"])
             for _ in range(2 if d["kind"] == "beta" else 1)]
        x = np.stack(x) if d["kind"] == "beta" else x[0]
      out.append(np.asarray(x, d["dtype"]))
    return out

  @staticmethod
  def _gamma_input(rng, shape, rounds):
    """[2R + 1, *shape]: R unit normals, then R + 1 uniforms in [0, 1)."""
    return np.concatenate([rng.standard_normal([rounds] + shape),
                           rng.random([rounds + 1] + shape)])

  @property
  def span_hook(self):
    return self._span_hook

  @span_hook.setter
  def span_hook(self, hook):
    self._span_hook = hook
    if hook is None:
      self._spans = [contextlib.nullcontext() for _ in SPANS]
    else:
      self._spans = [hook(name, request=True) if name == "act.call"
                     else hook(name) for name in SPANS]

  @torch.no_grad()
  def action(self, observation_leaves, state=None, step_type=None,
             key_data=None):
    call, prep = self._spans[:2]
    with call:
      with prep:
        batch = np.shape(observation_leaves[0])[0]
        flat_ts = self.make_time_step(observation_leaves, step_type)
        if state is None:
          state = self.initial_state(batch)
        if key_data is None:
          key_data = np.zeros((2,), np.uint32)
        draws = self.draw_inputs(batch, key_data)
      if self._stream is None:
        return self._op_by_op(draws, flat_ts, state)
      with self._lock, torch.cuda.stream(self._stream):
        return self._on_card(draws, flat_ts, state)

  def _op_by_op(self, draws, flat_ts, state):
    """The program called op by op, its inputs copied to the device and
    its outputs back."""
    _, _, upload, program, _, fetch = self._spans
    to = lambda xs: [torch.as_tensor(np.asarray(x)).to(self.device)
                     for x in xs]
    with upload:
      draws, flat_ts, state = to(draws), to(flat_ts), to(state)
    with program:
      acts, next_state = self._program(self.params, draws, flat_ts, state)
    with fetch:
      return ([a.cpu().numpy() for a in acts],
              [s.cpu().numpy() for s in next_state])

  def _on_card(self, draws, flat_ts, state):
    """A call on the policy's stream: op by op for a signature's first
    call, else through the signature's graph, captured first if it is
    not yet."""
    leaves = [np.asarray(x) for x in draws + flat_ts + list(state)]
    signature = (len(draws), len(flat_ts),
                 tuple((x.shape, x.dtype) for x in leaves))
    graph = self._graphs.get(signature)
    if graph is None:
      if signature not in self._seen:
        acts, next_state = self._op_by_op(draws, flat_ts, state)
        self._seen[signature] = (
            [(y.shape, y.dtype) for y in acts + next_state], len(acts))
        return acts, next_state
      graph = self._graphs[signature] = _Graph(
          signature[2], *self._seen.pop(signature), self.device)
    _, _, upload, program, replay, fetch = self._spans
    with upload:
      graph.stage(leaves)
    with program:
      if graph.graph is None:
        n, m = len(draws), len(draws) + len(flat_ts)
        graph.capture(self._stream, lambda xs: self._program(
            self.params, xs[:n], xs[n:m], xs[m:]))
      with replay:
        graph.graph.replay()
    with fetch:
      self._stream.synchronize()
      return graph.results()


class _Graph:
  """One input signature's CUDA graph and the buffers it reads and
  writes: pinned host buffers for the program's inputs and outputs, and
  device buffers for its inputs. A replay copies the inputs in, runs the
  program and copies the outputs out."""

  def __init__(self, inputs, outputs, num_acts, device):
    """`inputs` and `outputs` are (shape, numpy dtype) of each leaf;
    the first `num_acts` outputs are the action's."""
    pin = device.type == "cuda"
    host = lambda shape, dtype: torch.empty(
        shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
        pin_memory=pin)
    self.host_in = [host(*leaf) for leaf in inputs]
    self.device_in = [torch.empty_like(h, device=device)
                      for h in self.host_in]
    self.host_out = [host(*leaf) for leaf in outputs]
    self.views_in = [h.numpy() for h in self.host_in]
    self.views_out = [h.numpy() for h in self.host_out]
    self.num_acts = num_acts
    self.graph = None

  def stage(self, leaves):
    for view, x in zip(self.views_in, leaves):
      np.copyto(view, x)

  def run(self, program):
    """What a replay repeats: copy in, the program, copy out."""
    for d, h in zip(self.device_in, self.host_in):
      d.copy_(h, non_blocking=True)
    acts, next_state = program(self.device_in)
    for h, y in zip(self.host_out, list(acts) + list(next_state)):
      h.copy_(y, non_blocking=True)

  def capture(self, stream, program):
    """Capture `run(program)` on `stream`; the capture runs none of its
    work. Other threads may use the card meanwhile."""
    self.graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(self.graph, stream=stream,
                          capture_error_mode="thread_local"):
      self.run(program)

  def results(self):
    """Copies of the outputs (the next replay overwrites the buffers):
    (action leaves, next state leaves)."""
    out = [view.copy() for view in self.views_out]
    return out[:self.num_acts], out[self.num_acts:]
'''
