"""A run's last line and what it loads, through the test-only path that
runs on the CPU and writes no device metric."""
import json
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests._tiny import SEED, TINY

ROOT = harness.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell,trace", [
    ("dqn_mnih15.fused_b128", False), ("dqn_mnih15.fused_b128", True),
    ("sac_haarnoja18.fused_utd1", False), ("sac_haarnoja18.fused_utd1", True),
    ("dqn_mnih15.act_b1", False)])
def test_last_line_keys_on_the_cpu(cell, trace):
  line = harness.run_cell(cell, SEED, 0.5, trace, device="cpu",
                          fields=TINY[cell])
  assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
  assert line["correct"] is True and line["failed"] == 0
  assert line["attempted"] > 0
  assert line["metrics"] == {}
  assert line["device"]["platform"] == "cpu"
  assert set(line["checks"]) == set(harness.cell_spec(cell)["limits"])
  json.dumps(line, allow_nan=False)


def _fresh_python(code):
  env = dict(os.environ, PYTHONPATH=ROOT)
  return subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=600, env=env, cwd=ROOT)


def test_a_run_loads_neither_jax_nor_the_jax_package():
  code = (
      "import importlib.util, json, sys\n"
      "spec = importlib.util.spec_from_file_location('run', "
      "'portbench/run.py')\n"
      "run = importlib.util.module_from_spec(spec)\n"
      "spec.loader.exec_module(run)\n"
      "from portbench import harness, calibrate\n"
      "line = harness.run_cell('dqn_mnih15.fused_b128', 7, 0.2, True, "
      "'cpu', fields=" + repr(TINY["dqn_mnih15.fused_b128"]) + ")\n"
      "print(json.dumps(harness.forbidden_modules()))\n")
  out = _fresh_python(code)
  assert out.returncode == 0, out.stderr[-3000:]
  assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_program():
  code = ("import sys\n"
          "from portbench.reference import common, dqn, sac\n"
          "print(sorted({m.split('.')[0] for m in sys.modules} & "
          "{'agents_tpu', 'agents_tpu_torch', 'examples', 'jax', 'flax'}))\n")
  out = _fresh_python(code)
  assert out.returncode == 0, out.stderr[-3000:]
  assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
  out = subprocess.run(
      [sys.executable, "portbench/run.py", "--workload",
       "dqn_mnih15.fused_b128", "--seed", "1", "--seconds", "1", "--trace",
       "0"], capture_output=True, text=True, timeout=600, cwd=ROOT,
      env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
  assert out.returncode != 0 and out.stdout == ""
