"""The R2D2 cell (`r2d2_kapturowski19.seq120_b64`): its files, its adapter
against the plain reference, what the reference imports, the counting of
`portbench/lstm.py`, and, on the CPU at a tiny size, a sound run against
the faults planted in the program: the zero start carry in place of the
stored carry and burn-in, value rescaling off, and half of the batch."""
import math
import os
import subprocess
import sys

import pytest
import torch

from agents_tpu_torch.agents.dqn import r2d2_agent
from portbench import flops, harness, lstm
from portbench.programs import r2d2_pixels
from portbench.reference import r2d2
from portbench.tests._tiny import SEED

CELL = "r2d2_kapturowski19.seq120_b64"
TINY = {"pixels_size": 20, "conv_layer_params": [[4, 4, 2], [8, 3, 1]],
        "fc_layer_params": [16], "lstm_size": 8,
        "dueling_fc_layer_params": [8], "pixels_actions": 4,
        "pixels_horizon": 12, "env_batch_size": 4, "replay_capacity": 64,
        "sample_batch_size": 8, "burn_in": 4, "train_sequence_length": 10,
        "n_step_update": 2, "sequence_stride": 4, "initial_collect_steps": 12,
        "target_update_period": 5}
NEW = ("lstm_span_ms.env_steps", "burn_in_span_ms.env_steps",
       "lstm_launches.env_steps", "lstm_roofline.env_steps")


def _hp(fields=None):
  spec = harness.cell_spec(CELL)
  return {**spec["config"]["fields"], **(fields or {})}


def test_the_cells_files_load():
  spec = harness.cell_spec(CELL)
  assert spec["cell"]["chips"] == 1
  assert spec["traffic"]["kind"] == "fused_loop"
  assert spec["config"]["program"] == "r2d2_pixels"
  assert spec["config"]["peak"] == "fp32"
  assert spec["config"]["control"] == "tf32"
  assert "sample_mismatch" not in spec["limits"]
  names = {m["name"] for m in spec["per_layer"]}
  assert set(NEW) <= names
  assert {"device_idle_share.env_steps", "step_mfu.env_steps",
          "launches_per_iteration.env_steps"} <= names
  assert [m["name"] for m in spec["end_to_end"]] == ["env_steps_per_s",
                                                     "setup_s"]
  hp = _hp()
  assert hp["env_batch_size"] * hp["replay_capacity"] == 4_000_000
  assert spec["config"]["widths"]["parameters"] == sum(
      math.prod(s) for _, s, _, _ in r2d2.leaves(hp))


def test_the_adapters_leaves_are_the_programs_parameters():
  run = harness.Run(harness.cell_spec(CELL), SEED, 0.1, False, "cpu",
                    fields=TINY)
  loop, hp = run.adapter.build(run.config, run.device)
  params = r2d2_pixels._canonical(hp, loop.agent.q_network)
  shapes = {name: tuple(shape) for name, shape, _, _ in r2d2.leaves(hp)}
  assert list(params) == list(shapes)
  assert {n: tuple(p.shape) for n, p in params.items()} == shapes


def test_the_reference_imports_nothing_forbidden():
  code = ("import sys\n"
          "from portbench.reference import r2d2\n"
          "print(sorted({m.split('.')[0] for m in sys.modules} & "
          "{'agents_tpu', 'agents_tpu_torch', 'examples', 'jax', 'flax'}))\n")
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=harness.ROOT,
                       env=dict(os.environ, PYTHONPATH=harness.ROOT))
  assert out.returncode == 0, out.stderr[-3000:]
  assert out.stdout.strip().splitlines()[-1] == "[]"
  with open(os.path.join(harness.HERE, "reference", "r2d2.py")) as f:
    assert "_MaskedLSTMUnroll" not in f.read()


def test_the_counts_of_the_published_configuration():
  hp = _hp()
  # 13.8 MFLOP of torso a frame unpadded, 273 MFLOP of LSTM a step at 64
  # rows.
  assert lstm._torso_flops(hp) == 13_770_752
  assert 2 * 64 * (512 + 18 + 1 + 512) * 4 * 512 == 273_416_192
  per_iteration = lstm.r2d2_iteration_flops(hp)
  assert per_iteration == lstm.frame_forward_flops(hp) * (
      256 + 2 * 64 * 120 + 2 * 64 * 80)
  assert 0.45e12 < per_iteration < 0.55e12
  least = lstm.recurrence_least_seconds(hp, flops.PEAKS["fp32"])
  recurrent = 2 * 512 * 2048 * (256 + 64 * (2 * 120 + 2 * 80))
  assert recurrent / flops.PEAKS["fp32"] <= least < 2e-3


def test_device_time_is_put_down_to_the_launching_span():
  def x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, **({"args": args} if args else {})}

  events = [x("user_annotation", "agent.loss", 0, 100),
            x("user_annotation", "lstm.unroll", 10, 40),
            x("user_annotation", "lstm.backward", 0, 30, tid=2),
            x("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
            x("cuda_runtime", "cudaLaunchKernel", 60, 2, correlation=2),
            x("cuda_runtime", "cudaLaunchKernel", 5, 2, tid=2, correlation=3),
            x("kernel", "k1", 20, 5, tid=7, correlation=1),
            x("kernel", "k2", 70, 10, tid=7, correlation=2),
            x("kernel", "k3", 80, 4, tid=7, correlation=3)]
  got = lstm.device_seconds_by_span(
      events, {"agent.loss", "lstm.unroll", "lstm.backward"})
  assert got == pytest.approx({"lstm.unroll": 5e-6, "agent.loss": 10e-6,
                               "lstm.backward": 4e-6})


def _run(plant=None):
  return harness.run_cell(CELL, SEED, 0.3, False, device="cpu", plant=plant,
                          fields=TINY)


def test_a_sound_run_is_correct_and_reads_no_metric_on_the_cpu():
  run = harness.execute(CELL, SEED, 0.3, True, device="cpu", fields=TINY)
  line = harness.result_line(run)
  assert line["correct"] is True, line["checks"]
  assert line["failed"] == 0 and line["attempted"] > 0
  assert line["metrics"] == {}
  assert not set(NEW) & set(run.layer_metrics)
  assert set(line["checks"]) == set(harness.cell_spec(CELL)["limits"])


def zero_carry(loop):
  """Every train step starts both networks from a zero carry at the
  trained frames: no stored carry, no burn-in."""
  agent = loop.agent
  original = agent._unroll

  def unroll(network, experience, start, stop, state):
    if start == 0 and stop == agent.burn_in:
      return None, tuple(torch.zeros_like(s) for s in state)
    return original(network, experience, start, stop, state)

  agent._unroll = unroll


def half_batch(loop):
  """Every train step's loss is the mean over the first half of its
  sequences (the other half weighs nothing)."""
  original = loop.agent.train

  def train(agent_state, experience, weights=None):
    weights = weights.clone()
    weights[weights.shape[0] // 2:] = 0
    return original(agent_state, experience, weights=2 * weights)

  loop.agent.train = train


@pytest.mark.parametrize("plant", [zero_carry, half_batch],
                         ids=lambda p: p.__name__)
def test_a_planted_fault_is_not_correct(plant):
  line = _run(plant)
  assert line["correct"] is False, line["checks"]


def test_value_rescaling_off_is_not_correct(monkeypatch):
  monkeypatch.setattr(r2d2_agent, "value_rescale", lambda x, eps: x)
  monkeypatch.setattr(r2d2_agent, "inverse_value_rescale", lambda x, eps: x)
  line = _run()
  assert line["correct"] is False, line["checks"]
