"""The port's DQN-CartPole example: a CPU smoke run at a tiny size, its
command line, and the committed 100k-iteration learning artifact."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
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


# -- the pixel example --------------------------------------------------------


def test_pixel_example_flags_and_bench_defaults():
  """The defaults are `bench.py:conv_bench`'s construction; --env=catch
  and --agent=c51 select presets, which --smoke and --cfg.* override."""
  from examples.dqn_pixels_torch import MNIH15, Config, parse_pixel_args
  bench = Config()
  assert (bench.env, bench.agent, bench.env_batch_size,
          bench.sample_batch_size, bench.replay_capacity,
          bench.initial_collect_steps) == ("pixels", "dqn", 128, 256, 2048, 64)
  assert bench.conv_layer_params == MNIH15 == (
      (32, 8, 4), (64, 4, 2), (64, 3, 1))
  assert (bench.fc_layer_params, bench.dtype, bench.scale_pixels) == (
      (512,), "bfloat16", True)
  assert (bench.learning_rate, bench.adam_eps, bench.epsilon_greedy,
          bench.gamma, bench.target_update_tau, bench.target_update_period,
          bench.td_loss, bench.return_buffer, bench.seed, bench.device) == (
              2.5e-4, 1.5e-4, 0.05, 0.99, 1.0, 500, "huber", 20, 0, "cuda")
  cfg = parse_pixel_args(["--env=catch", "--agent=c51", "--smoke",
                          "--device=cpu", "--cfg.conv_layer_params=8x3x1,4x3x2",
                          "--cfg.scale_pixels=false"])
  assert (cfg.env, cfg.agent, cfg.device) == ("catch", "c51", "cpu")
  assert (cfg.num_iterations, cfg.env_batch_size) == (200, 16)
  assert cfg.conv_layer_params == ((8, 3, 1), (4, 3, 2))
  assert cfg.scale_pixels is False and cfg.target_update_period == 50


@pytest.mark.parametrize("agent", ["dqn", "c51"])
def test_pixel_example_command_line_on_cpu(tmp_path, agent):
  out = subprocess.run(
      [sys.executable, os.path.join(ROOT, "examples", "dqn_pixels_torch.py"),
       f"--agent={agent}", "--device", "cpu", "--smoke",
       f"--cfg.root_dir={tmp_path}", "--cfg.pixels_size=12",
       "--cfg.pixels_horizon=8", "--cfg.conv_layer_params=4x3x2",
       "--cfg.fc_layer_params=16", "--cfg.env_batch_size=4",
       "--cfg.num_iterations=20", "--cfg.log_interval=10",
       "--cfg.num_eval_episodes=4"],
      capture_output=True, text=True, timeout=300, cwd=ROOT)
  assert out.returncode == 0, out.stderr
  final = json.loads(out.stdout.strip().splitlines()[-1])
  assert math.isfinite(final["final_average_return"])
  assert 0.0 <= final["eval_average_return"] <= 8.0
  records = _records(tmp_path / "train.jsonl")
  assert [r["step"] for r in records if "loss" in r] == [10, 20]
  with open(tmp_path / "config.json") as f:
    assert json.load(f)["agent"] == agent


# -- the SAC example ----------------------------------------------------------


def test_sac_example_bench_defaults_and_live_preset():
  """The defaults are the SAC bench point (``bench.py:sac_live_probe``'s
  agent and replay); --preset=live is ``tests/test_live_windows.py:89-123``
  exactly; --smoke and --cfg.* override either."""
  from examples.sac_pendulum_torch import Config, parse_sac_args
  bench = Config()
  assert (bench.env_batch_size, bench.replay_capacity,
          bench.sample_batch_size, bench.train_steps_per_iteration,
          bench.initial_collect_steps) == (32, 4096, 256, 32, 64)
  assert (bench.actor_fc_layers, bench.critic_joint_fc_layers) == (
      (256, 256), (256, 256))
  assert (bench.actor_lr, bench.critic_lr, bench.alpha_lr, bench.gamma,
          bench.target_update_tau, bench.reward_scale_factor,
          bench.max_episode_steps, bench.device) == (
              3e-4, 3e-4, 3e-4, 0.99, 0.005, 0.1, 200, "cuda")
  live = parse_sac_args(["--preset=live"])
  assert (live.env_batch_size, live.replay_capacity, live.sample_batch_size,
          live.train_steps_per_iteration, live.initial_collect_steps,
          live.num_iterations) == (8, 8192, 256, 4, 128, 8000)
  assert (live.actor_fc_layers, live.critic_joint_fc_layers) == (
      (64, 64), (64, 64))
  assert (live.reward_scale_factor, live.target_update_tau, live.gamma,
          live.actor_lr, live.critic_lr, live.alpha_lr) == (
              1.0, 0.005, 0.99, 3e-4, 3e-4, 3e-4)
  cfg = parse_sac_args(["--preset=live", "--smoke", "--device=cpu",
                        "--cfg.actor_fc_layers=8,8", "--cfg.seed=3"])
  assert (cfg.num_iterations, cfg.env_batch_size, cfg.device, cfg.seed) == (
      200, 8, "cpu", 3)
  assert cfg.actor_fc_layers == (8, 8)
  with pytest.raises(SystemExit):
    parse_sac_args(["--preset=halfcheetah"])


def test_sac_example_command_line_on_cpu(tmp_path):
  out = subprocess.run(
      [sys.executable, os.path.join(ROOT, "examples", "sac_pendulum_torch.py"),
       "--device", "cpu", "--smoke", f"--cfg.root_dir={tmp_path}",
       "--cfg.env_batch_size=4", "--cfg.max_episode_steps=10",
       "--cfg.actor_fc_layers=8", "--cfg.critic_joint_fc_layers=8",
       "--cfg.num_iterations=20", "--cfg.log_interval=10"],
      capture_output=True, text=True, timeout=300, cwd=ROOT)
  assert out.returncode == 0, out.stderr
  final = json.loads(out.stdout.strip().splitlines()[-1])
  assert math.isfinite(final["final_average_return"])
  # Ten steps of at most -(pi^2 + 0.1 * 8^2 + 0.001 * 2^2) each.
  assert -170.0 <= final["eval_average_return"] <= 0.0
  records = _records(tmp_path / "train.jsonl")
  assert [r["step"] for r in records if "loss" in r] == [10, 20]
  with open(tmp_path / "config.json") as f:
    saved = json.load(f)
  assert saved["max_episode_steps"] == 10 and saved["actor_fc_layers"] == [8]


def test_sac_example_train_eval_smoke_on_cpu(tmp_path):
  """`train_eval` over the SAC loop: finite losses, a logged return and a
  greedy eval over exactly the episodes asked for."""
  from examples.sac_pendulum_torch import SMOKE, Config, build_loop
  cfg = Config(**{**SMOKE, "num_iterations": 40, "log_interval": 20,
                  "env_batch_size": 4}, root_dir=str(tmp_path),
               max_episode_steps=12, device="cpu")
  final, eval_return = train_eval(cfg, build=build_loop)
  assert math.isfinite(final) and final < 0.0
  assert -250.0 <= eval_return < 0.0
  records = _records(tmp_path / "train.jsonl")
  losses = [r["loss"] for r in records if "loss" in r]
  assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
  assert records[-1]["EvalAverageReturn"] == eval_return


# -- the PPO example ----------------------------------------------------------


def test_ppo_example_defaults_and_schulman17_preset():
  """The defaults are ``examples/ppo_cartpole.py``'s Config; the
  schulman17_pendulum preset is ``examples/ppo_halfcheetah.py``'s
  operating point on the device Pendulum; --smoke and --cfg.* override
  either."""
  from examples import ppo_cartpole, ppo_halfcheetah
  from examples.ppo_cartpole_torch import Config, parse_ppo_args
  cartpole = Config()
  for f in dataclasses.fields(ppo_cartpole.Config):
    if f.name != "root_dir":
      assert getattr(cartpole, f.name) == f.default, f.name
  assert (cartpole.env, cartpole.activation, cartpole.initial_std,
          cartpole.adam_eps, cartpole.lr_decay, cartpole.gradient_clipping,
          cartpole.device) == ("cartpole", "relu", 0.0, 1e-8, False, 0.0,
                               "cuda")
  pend = parse_ppo_args(["--preset=schulman17_pendulum"])
  skipped = {"root_dir", "env_name", "eval_every_iterations"}
  for f in dataclasses.fields(ppo_halfcheetah.Config):
    if f.name not in skipped:
      assert getattr(pend, f.name) == f.default, f.name
  assert (pend.env, pend.activation, pend.initial_std, pend.adam_eps,
          pend.lr_decay) == ("pendulum", "tanh", 0.35, 1e-5, True)
  # 2,048 training frames in 32 minibatches of 64.
  assert (pend.rollout_length - 1) // pend.num_minibatches == 64
  cfg = parse_ppo_args(["--preset=schulman17_pendulum", "--smoke",
                        "--device=cpu", "--cfg.actor_fc_layers=8,8"])
  assert (cfg.env, cfg.num_iterations, cfg.rollout_length, cfg.device,
          cfg.actor_fc_layers) == ("pendulum", 20, 65, "cpu", (8, 8))
  with pytest.raises(SystemExit):
    parse_ppo_args(["--preset=halfcheetah"])


@pytest.mark.parametrize("preset", [None, "schulman17_pendulum"])
def test_ppo_example_command_line_on_cpu(tmp_path, preset):
  args = [] if preset is None else [f"--preset={preset}"]
  out = subprocess.run(
      [sys.executable, os.path.join(ROOT, "examples", "ppo_cartpole_torch.py"),
       *args, "--device", "cpu", "--smoke", f"--cfg.root_dir={tmp_path}",
       "--cfg.env_batch_size=4", "--cfg.max_episode_steps=20",
       "--cfg.actor_fc_layers=8", "--cfg.value_fc_layers=8",
       "--cfg.num_eval_envs=2"],
      capture_output=True, text=True, timeout=300, cwd=ROOT)
  assert out.returncode == 0, out.stderr
  final = json.loads(out.stdout.strip().splitlines()[-1])
  assert math.isfinite(final["final_average_return"])
  if preset is None:
    assert 0.0 < final["eval_average_return"] <= 20.0
  else:
    # Twenty steps of at most -(pi^2 + 0.1 * 8^2 + 0.001 * 2^2) each.
    assert -340.0 <= final["eval_average_return"] <= 0.0
  records = _records(tmp_path / "train.jsonl")
  assert [r["step"] for r in records if "loss" in r] == [10, 20]
  assert "EvalAverageReturn" in records[-1]
  with open(tmp_path / "config.json") as f:
    saved = json.load(f)
  assert saved["env"] == ("cartpole" if preset is None else "pendulum")


def test_ppo_example_train_eval_smoke_on_cpu(tmp_path):
  """`train_eval` over the PPO loop: finite losses, a logged return, and a
  greedy eval over exactly the episodes asked for."""
  from examples.ppo_cartpole_torch import SMOKE, Config
  from examples.ppo_cartpole_torch import train_eval as ppo_train_eval
  cfg = Config(**{**SMOKE, "num_iterations": 4, "log_interval": 2},
               root_dir=str(tmp_path), env_batch_size=4,
               actor_fc_layers=(8,), value_fc_layers=(8,), num_eval_envs=3,
               device="cpu")
  final, eval_return = ppo_train_eval(cfg)
  assert math.isfinite(final) and 0.0 < eval_return <= 200.0
  records = _records(tmp_path / "train.jsonl")
  losses = [r["loss"] for r in records if "loss" in r]
  assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
  assert records[-1]["EvalAverageReturn"] == eval_return
