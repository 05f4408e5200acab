"""`examples/sac_halfcheetah_torch.py` and `examples/ppo_halfcheetah_torch.py`
at smoke size on the CPU (gymnasium's MuJoCo HalfCheetah-v5 on the host),
each run twice in one `root_dir`: the second run resumes from the first's
last checkpoint toward a higher target, continuing its counters and its
log. Each example's `Config` keeps its JAX counterpart's defaults.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(example, root_dir, *flags):
  out = subprocess.run(
      [sys.executable, os.path.join(ROOT, "examples", example), "--smoke",
       "--device", "cpu", f"--cfg.root_dir={root_dir}", *flags],
      capture_output=True, text=True, timeout=240,
      env={**os.environ, "OMP_NUM_THREADS": "2"})
  assert out.returncode == 0, out.stderr[-3000:]
  return json.loads(out.stdout.strip().splitlines()[-1]), out.stdout


def test_sac_halfcheetah_smoke_and_resume(tmp_path):
  root = str(tmp_path / "sac")
  first, _ = _run("sac_halfcheetah_torch.py", root)
  assert first["env_steps"] == 400 and first["trainer_drained"]
  assert first["train_steps"] > 0
  assert first["eval_average_return"] < 0.0
  steps = sorted(int(n[:-3]) for n in os.listdir(
      os.path.join(root, "checkpoints")))
  assert steps == [100, 200]               # ticks; two kept
  second, _ = _run("sac_halfcheetah_torch.py", root,
                   "--cfg.total_env_steps=600")
  assert second["env_steps"] == 600        # resumed at tick 200
  assert second["train_steps"] >= first["train_steps"]
  with open(os.path.join(root, "train.jsonl")) as f:
    lines = [json.loads(line) for line in f]
  evals = [line for line in lines if "EvalAverageReturn" in line]
  assert [e["step"] for e in evals] == [400, 600]


def test_ppo_halfcheetah_smoke_and_resume(tmp_path):
  root = str(tmp_path / "ppo")
  first, _ = _run("ppo_halfcheetah_torch.py", root)
  assert first["env_steps"] == 4 * 65 and first["resumed_from"] == 0
  second, stdout = _run("ppo_halfcheetah_torch.py", root,
                        "--cfg.num_iterations=6")
  assert "resumed from iteration 4" in stdout
  assert second["resumed_from"] == 4
  assert second["env_steps"] == 6 * 65     # the metric state carried on
  assert sorted(os.listdir(os.path.join(root, "checkpoints"))) == [
      "4.pt", "6.pt"]


@pytest.mark.parametrize("example,jax_example", [
    ("sac_halfcheetah_torch", "sac_halfcheetah"),
    ("ppo_halfcheetah_torch", "ppo_halfcheetah")])
def test_config_defaults_equal_the_jax_examples(example, jax_example):
  sys.path.insert(0, os.path.join(ROOT, "examples"))
  import importlib
  port = dataclasses.asdict(importlib.import_module(example).Config())
  jax = dataclasses.asdict(importlib.import_module(jax_example).Config())
  for name, value in jax.items():
    if name != "root_dir":
      assert port[name] == value, name
  assert port["device"] == "cuda"
