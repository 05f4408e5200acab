"""The benchmark's files, found by the names in ``BENCHMARK.json``, and
the arithmetic it counts with (CPU)."""
import json
import os
import re

import pytest

from portbench import drive, flops, harness, reads
from portbench import devtrace
from portbench.reference import dqn, sac

BENCH = harness.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_token")


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_resolves(cell):
  spec = harness.cell_spec(cell)
  assert spec["traffic"]["kind"] in drive.KINDS
  assert os.path.exists(os.path.join(
      harness.HERE, "programs", spec["config"]["program"] + ".py"))
  assert spec["limits"], "a cell is judged by at least one number"
  assert spec["end_to_end"] and spec["per_layer"]
  assert "setup_s" in [m["name"] for m in spec["end_to_end"]]
  for metric in spec["per_layer"]:
    assert callable(harness.reader(metric["name"]).read)
  for metric in spec["end_to_end"]:
    if metric["source"] == "device_trace":
      assert callable(harness.reader(metric["name"]).read)


def test_benchmark_keeps_to_the_contract_shape():
  assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
  assert BENCH["paths"] == ["portbench"]
  assert 1 <= BENCH["run_seconds"] <= 51
  names = [c["name"] for c in BENCH["configs"]] + CELLS + [
      m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
  assert len(names) == len(set(names))
  assert all(NAME.match(n) for n in names)
  for config in BENCH["configs"]:
    assert os.path.exists(os.path.join(harness.ROOT, config["file"]))
    assert config["name"] in {c["config"] for c in BENCH["workloads"]}
    for key in config["reduced"]:
      assert NAME.match(key) and not key.endswith(("_dim", "_rank"))
      assert not any(w in key for w in WIDTH_WORDS), key
  for cell in BENCH["workloads"]:
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
  for metric in BENCH["end_to_end"]:
    assert 0.01 <= metric["bound"] <= 0.25
    assert metric["source"] in ("host_clock", "device_trace")
  for metric in BENCH["end_to_end"] + BENCH["per_layer"]:
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower",
                                                               "higher")
  moved = {m["name"] for m in BENCH["end_to_end"]}
  for metric in BENCH["per_layer"]:
    assert metric["moves"] in moved and set(metric["workloads"]) <= set(CELLS)
  assert len(json.dumps(BENCH)) < 64 * 1024


# The bounds PERF.md section 2 sets from the two sets of runs per cell.
BOUNDS = {"env_steps_per_s": 0.25, "train_step_device_ms": 0.025,
          "act_latency_mean_ms": 0.25, "setup_s": 0.25}


def test_bounds_are_the_documented_ones():
  assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]} == BOUNDS


def test_reduced_keys_are_the_configuration_files():
  for config in BENCH["configs"]:
    with open(os.path.join(harness.ROOT, config["file"])) as f:
      assert sorted(json.load(f)["reduced"]) == sorted(config["reduced"])


def test_every_metric_file_is_a_metric():
  files = {f[:-3] for f in os.listdir(os.path.join(harness.HERE, "metrics"))
           if f.endswith(".py")}
  assert files == {m["name"] for m in BENCH["per_layer"]} | {
      m["name"] for m in BENCH["end_to_end"] if m["source"] == "device_trace"}


def _hp(config):
  path = os.path.join(harness.HERE, "configs", f"{config}.json")
  with open(path) as f:
    spec = json.load(f)
  return {**spec["fields"], **spec.get("stated", {})}


def test_copied_flop_counts():
  hp = _hp("dqn_mnih15")
  fwd = flops.conv_forward_flops(84, 4, 6, hp["conv_layer_params"],
                                 hp["fc_layer_params"])
  assert fwd == 32_012_288
  per_iteration = flops.conv_iteration_flops(
      84, 4, 6, hp["env_batch_size"], hp["sample_batch_size"],
      hp["conv_layer_params"], hp["fc_layer_params"])
  assert round(per_iteration / 1e9, 3) == 36.878
  hp = _hp("sac_haarnoja18")
  step = flops.sac_train_step_flops(256, 3, 1, hp["actor_fc_layers"],
                                    hp["critic_joint_fc_layers"])
  assert round(step / 1e9, 3) == 0.547


def test_reference_widths_are_the_published_ones():
  hp = _hp("dqn_mnih15")
  leaves = dqn.leaves(hp)
  assert sum(int(__import__("math").prod(s)) for _, s, _, _ in leaves) \
      == 4_046_502
  hp = _hp("sac_haarnoja18")
  shapes = {n: s for n, s, _, _ in sac.leaves(hp)}
  assert shapes["actor.l1.weight"] == (256, 256)
  assert shapes["critic2.l0.weight"] == (256, 4)


def test_least_times_are_below_the_counted_work():
  hp = _hp("dqn_mnih15")
  least = flops.conv_least_seconds(84, 4, hp["conv_layer_params"], 128, 256,
                                   2, flops.PEAKS["bf16_dense"])
  conv_flops = 4 * 256 * 24_076_288 + 128 * 24_076_288
  assert conv_flops / flops.PEAKS["bf16_dense"] <= least
  gemms = flops.sac_step_gemms(256, 3, 1, (256, 256), (256, 256))
  total = sum(2 * r * i * o for r, i, o, _ in gemms)
  # The GEMMs enumerated are sac_train_step_flops' 4A + 12C less the
  # first layers' input gradients it counts.
  assert 0.9 < total / flops.sac_train_step_flops(256, 3, 1, (256, 256),
                                                  (256, 256)) <= 1.0


def test_trace_reduction_unions_device_spans_and_labels_gaps():
  events = [
      {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
      {"ph": "X", "cat": "kernel", "name": "k2", "ts": 5, "dur": 10},
      {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 40, "dur": 10},
      {"ph": "X", "cat": "user_annotation", "name": "portbench.train",
       "ts": 0, "dur": 60},
      {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 18, "dur": 4},
  ]
  out = devtrace.reduce_trace(events, wall_s=1e-4)
  assert out["busy_s"] == pytest.approx(25e-6)
  assert out["device_ops"] == 3
  assert out["idle_gaps"] == [["portbench.train: between ops",
                               pytest.approx(25e-6)]]


class _Run:
  def __init__(self, **kw):
    self.__dict__.update(kw)


def test_readers_count_from_the_window_and_profile():
  profile = {"busy_s": 0.1, "window_s": 1.0, "units": 10, "device_ops": 3000,
             "op_device_s": {"aten::convolution": 0.02,
                             "aten::convolution_backward": 0.03}}
  run = _Run(profile=profile, window={"seconds": 2.0, "iterations": 100},
             model={"peak": 1e12, "flops_per_iteration": 1e9,
                    "train_steps_per_iteration": 1,
                    "conv_least_s_per_iteration": 1e-4},
             traffic={}, probes={})
  # 0.01 s busy per iteration, 100 iterations in the 2 s timed window.
  assert reads.idle_share(run) == pytest.approx(50.0)
  assert reads.step_mfu_iterations(run) == pytest.approx(5.0)
  assert reads.conv_roofline(run) == pytest.approx(2.0)
  assert reads.launches_per_iteration(run) == 300
  assert reads.launches_per_call(run) is None
  assert reads.gemm_roofline(run) is None
  assert reads.collect_ms(run) is None
  # 0.01 s busy per iteration of 4 train steps; 1 GFLOP a step at 1 TFLOP/s.
  run.model.update(train_steps_per_iteration=4, flops_per_train_step=1e9)
  assert reads.train_step_device_ms(run) == pytest.approx(2.5)
  assert reads.step_mfu_train_steps(run) == pytest.approx(40.0)
  run.window["train_steps_per_s"] = 123.0
  assert reads.host_train_steps_per_s(run) == 123.0
  run.profile["busy_s"] = 0.0
  assert reads.train_step_device_ms(run) is None


def test_end_to_end_metrics_from_the_trace_are_read_in_every_run():
  spec = harness.cell_spec("sac_haarnoja18.fused_utd1")
  run = _Run(spec=spec, profile={"busy_s": 0.2, "window_s": 3.0, "units": 2},
             window={"seconds": 30.0, "iterations": 80,
                     "train_steps_per_s": 85.3},
             model={"train_steps_per_iteration": 32})
  assert harness.profiles_every_run(run)
  harness.read_end_to_end(run)
  # 0.1 s busy per iteration of 32 train steps.
  assert run.window["train_step_device_ms"] == pytest.approx(3.125)
  assert run.window["train_steps_per_s"] == 85.3
  assert not harness.profiles_every_run(
      _Run(spec=harness.cell_spec("dqn_mnih15.act_b1")))
