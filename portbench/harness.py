"""Runs one cell once and makes its result line.

A cell is found by the names in ``BENCHMARK.json``: its configuration
file (``configs/<config>.json``, which names its program adapter under
``programs/``), its traffic file (``traffic/<traffic>.json``, whose
``kind`` picks the driver in `drive.KINDS`), its limits
(``limits/<cell>.json``) and one reader per per-layer metric and per
end-to-end metric read from the device's trace (``metrics/<metric>.py``).
Nothing here belongs to one configuration, traffic mix or metric.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "agents_tpu")


def _json(path):
  with open(path) as f:
    return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
  return _json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
  return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(name: str, bench: dict = None) -> dict:
  """Everything the harness reads for cell `name`."""
  bench = bench or load_benchmark()
  cells = {c["name"]: c for c in bench["workloads"]}
  if name not in cells:
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")
  cell = cells[name]
  config = next(c for c in bench["configs"] if c["name"] == cell["config"])
  return {
      "cell": cell,
      "config": _json(os.path.join(ROOT, config["file"])),
      "traffic": _json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json")),
      "limits": _json(os.path.join(HERE, "limits", f"{name}.json"))["limits"],
      "end_to_end": [m for m in bench["end_to_end"] if _reports(m, name)],
      "per_layer": [m for m in bench["per_layer"] if _reports(m, name)],
  }


def reader(metric: str):
  """The module of ``metrics/<metric>.py`` (its `read(run)`)."""
  path = os.path.join(HERE, "metrics", f"{metric}.py")
  spec = importlib.util.spec_from_file_location(
      "portbench_metric_" + metric.replace(".", "_"), path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def forbidden_modules() -> list:
  """Top-level names in `sys.modules`, compared whole, that the run must
  not hold."""
  return sorted({name.split(".")[0] for name in list(sys.modules)}
                & set(FORBIDDEN))


def tf32_off():
  import torch
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False


class Run:
  """One run's state, handed to the driver and to the metric readers."""

  def __init__(self, spec, seed, seconds, trace, device, plant=None,
               fields=None, t_start=None):
    import torch
    self.spec, self.seed, self.seconds, self.trace = spec, seed, seconds, trace
    self.device = torch.device(device)
    self.plant = plant
    self.traffic = spec["traffic"]
    self.config = dict(spec["config"])
    self.config["fields"] = {**self.config["fields"], **(fields or {})}
    self.adapter = importlib.import_module(
        f"portbench.programs.{self.config['program']}")
    self.t_start = time.perf_counter() if t_start is None else t_start
    self.setup_s = None
    self.window = {}
    self.profile = None
    self.memory_peak_bytes = None
    self.numbers = {}
    self.attempted = self.failed = 0
    self.hp = self.model = None
    self.probes = {}    # handles the readers time: loop, state, exported...
    self.layer_metrics = {}
    self.judged = {}    # what the numbers were worked out from

  @property
  def on_card(self) -> bool:
    return self.device.type == "cuda"

  def sync(self):
    import torch
    if self.on_card:
      torch.cuda.synchronize(self.device)

  def time_calls(self, fn, min_seconds: float = 0.3) -> float:
    """ms per call of `fn` over calls that span at least `min_seconds` of
    host clock, ended by a synchronize."""
    self.sync()
    calls, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < min_seconds:
      fn()
      calls += 1
    self.sync()
    return (time.perf_counter() - t0) * 1e3 / calls

  def free_program(self):
    """Drop the program's state before the reference runs."""
    import torch
    self.probes.clear()
    gc.unfreeze()
    gc.collect()
    if self.on_card:
      torch.cuda.empty_cache()


def profiles_every_run(run: Run) -> bool:
  """Whether the cell has an end-to-end metric read from the device's
  trace, which a `--trace 0` run reports too."""
  return any(m["source"] == "device_trace" for m in run.spec["end_to_end"])


def read_end_to_end(run: Run):
  """Adds to `run.window` each of the cell's end-to-end metrics that has a
  reader of its own (``metrics/<metric>.py``) and finds something to
  read; the others the driver takes from the window itself."""
  for metric in run.spec["end_to_end"]:
    path = os.path.join(HERE, "metrics", f"{metric['name']}.py")
    if os.path.exists(path):
      value = reader(metric["name"]).read(run)
      if value is not None:
        run.window[metric["name"]] = value


def read_layers(run: Run) -> dict:
  """The cell's per-layer metrics that its readers find something for."""
  out = {}
  for metric in run.spec["per_layer"]:
    value = reader(metric["name"]).read(run)
    if value is not None:
      out[metric["name"]] = {"value": value, "unit": metric["unit"]}
  return out


def card_line() -> str:
  """The card's name and power limit as ``nvidia-smi`` prints them."""
  import subprocess
  try:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
  except (OSError, subprocess.SubprocessError, IndexError):
    return "not read"


def execute(name: str, seed: int, seconds: float, trace: bool,
            device="cuda", plant=None, fields=None, t_start=None) -> Run:
  """Run cell `name` once: set-up, window, per-layer reads when traced,
  and the numbers that decide `correct`. `plant` breaks the program under
  test and `fields` overrides configuration fields (tests only)."""
  from portbench import drive

  tf32_off()
  run = Run(cell_spec(name), seed, seconds, trace, device, plant, fields,
            t_start)
  drive.KINDS[run.traffic["kind"]](run)
  return run


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", plant=None, fields=None, t_start=None) -> dict:
  """The result line of one run of cell `name` (`execute`). On the CPU
  (tests only) the line holds no metric: only the card's are device
  metrics."""
  return result_line(execute(name, seed, seconds, trace, device, plant,
                             fields, t_start))


def result_line(run: Run) -> dict:
  import torch

  from portbench import judge

  trace = run.trace
  limits = run.spec["limits"]
  correct = judge.limits_hold(run.numbers, limits) and run.failed == 0
  checks = {k: {"value": run.numbers.get(k), "limit": v}
            for k, v in limits.items()}
  device_info = {"platform": "cpu", "kind": "cpu", "count": 0,
                 "memory_peak_bytes": None}
  metrics = {}
  if run.on_card:
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(run.device),
                   "count": 1, "memory_peak_bytes": run.memory_peak_bytes}
    for metric in run.spec["end_to_end"]:
      metrics[metric["name"]] = {"value": run.window[metric["name"]],
                                 "unit": metric["unit"]}
    if trace:
      metrics = run.layer_metrics
      device_info["busy_s"] = run.profile["busy_s"]
      device_info["window_s"] = run.profile["window_s"]
  line = {"correct": bool(correct), "attempted": run.attempted,
          "failed": run.failed, "metrics": metrics, "device": device_info}
  if trace and run.on_card:
    line["breakdown"] = {"device_ops": run.profile["device_ops_top"],
                         "idle_gaps": run.profile["idle_gaps"]}
  if run.on_card:
    line["card"] = card_line()
  line["checks"] = checks
  return line
