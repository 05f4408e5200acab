"""The port's DQN-CartPole example: a CPU smoke run at a tiny size, its
command line, and the committed 100k-iteration learning artifact."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import torch

from examples.dqn_cartpole_torch import Config, parse_args, train_eval

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "results")


def _records(path):
  with open(path) as f:
    return [json.loads(line) for line in f]


def test_train_eval_smoke_on_cpu(tmp_path):
  cfg = Config(root_dir=str(tmp_path), env_batch_size=8, num_iterations=300,
               initial_collect_steps=16, replay_capacity=64,
               sample_batch_size=16, fc_layer_params=(16, 8),
               log_interval=100, num_eval_episodes=8, device="cpu")
  final, eval_return = train_eval(cfg)
  assert math.isfinite(final) and 0.0 < eval_return <= 200.0
  records = _records(tmp_path / "train.jsonl")
  losses = [r["loss"] for r in records if "loss" in r]
  assert [r["step"] for r in records if "loss" in r] == [100, 200, 300]
  assert all(math.isfinite(x) for x in losses)
  assert records[-1]["EvalAverageReturn"] == eval_return


def test_command_line_writes_config_and_final_line(tmp_path):
  out = subprocess.run(
      [sys.executable, os.path.join(ROOT, "examples", "dqn_cartpole_torch.py"),
       "--device", "cpu", f"--cfg.root_dir={tmp_path}",
       "--cfg.env_batch_size=4", "--cfg.num_iterations=20",
       "--cfg.initial_collect_steps=4", "--cfg.replay_capacity=16",
       "--cfg.sample_batch_size=8", "--cfg.fc_layer_params=8",
       "--cfg.log_interval=10", "--cfg.num_eval_episodes=4"],
      capture_output=True, text=True, timeout=120, cwd=ROOT)
  assert out.returncode == 0, out.stderr
  final = json.loads(out.stdout.strip().splitlines()[-1])
  assert set(final) == {"final_average_return", "eval_average_return", "seed"}
  with open(tmp_path / "config.json") as f:
    saved = json.load(f)
  assert saved["device"] == "cpu" and saved["fc_layer_params"] == [8]


def test_parse_args():
  cfg = parse_args(["--smoke", "--device=cpu", "--cfg.gamma=0.9",
                    "--cfg.fc_layer_params=32,16"], Config())
  assert (cfg.num_iterations, cfg.log_interval) == (2000, 500)
  assert cfg.device == "cpu" and cfg.gamma == 0.9
  assert cfg.fc_layer_params == (32, 16)
  assert Config().device == "cuda"


def test_learning_artifact_matches_the_jax_run_and_solves_cartpole():
  """results/dqn_cartpole_torch_s0.*: the port run at the JAX run's
  setup (results/dqn_cartpole_s0_config.json) reached a greedy eval of at
  least 195 after 100k iterations."""
  with open(os.path.join(RESULTS, "dqn_cartpole_torch_s0_config.json")) as f:
    torch_cfg = json.load(f)
  with open(os.path.join(RESULTS, "dqn_cartpole_s0_config.json")) as f:
    jax_cfg = json.load(f)
  ignored = {"root_dir", "device"}
  assert ({k: v for k, v in torch_cfg.items() if k not in ignored}
          == {k: v for k, v in jax_cfg.items() if k not in ignored})
  assert set(torch_cfg) - set(jax_cfg) == {"device"}
  assert {f.name for f in dataclasses.fields(Config)} == set(torch_cfg)
  records = _records(os.path.join(RESULTS, "dqn_cartpole_torch_s0.jsonl"))
  evals = [(r["step"], r["EvalAverageReturn"]) for r in records
           if "EvalAverageReturn" in r]
  assert evals, "no greedy-eval record in the artifact"
  step, value = evals[-1]
  assert step == torch_cfg["num_iterations"] == 100_000
  assert value >= 195.0
  returns = [r["AverageReturn"] for r in records if "AverageReturn" in r]
  assert len(returns) == 50 and all(0.0 < r <= 200.0 for r in returns)
