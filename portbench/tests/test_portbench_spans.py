"""The span readers (`portbench/spans.py`): the arithmetic on a hand-made
chrome trace and recording, the stretches on tiny loops and an export on
the CPU, and no number from a CPU run."""
import shutil
import tempfile

import numpy as np
import pytest

from portbench import drive, harness, inputs, spans
from portbench.tests._tiny import SEED, TINY

NEW = {
    "dqn_mnih15.fused_b128": (
        "collect_span_ms.env_steps", "insert_span_ms.env_steps",
        "sample_span_ms.env_steps", "loss_span_ms.env_steps",
        "grad_span_ms.env_steps", "apply_span_ms.env_steps",
        "loop_self_ms.env_steps", "apply_launches.env_steps"),
    "sac_haarnoja18.fused_utd1": (
        "sample_span_ms.train_steps", "loss_span_ms.train_steps",
        "grad_span_ms.train_steps", "apply_span_ms.train_steps",
        "loop_self_ms.train_steps", "apply_launches.train_steps"),
    "dqn_mnih15.act_b1": (
        "act_prep_span_ms.act", "act_upload_span_ms.act",
        "act_program_span_ms.act", "act_fetch_span_ms.act"),
}
DIVIDE = ("loop.collect", "loop.sample", "agent.loss", "agent.grad",
          "agent.apply")


def _x(cat, name, ts, dur, tid=1, **args):
  out = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
  if args:
    out["args"] = args
  return out


def test_trace_reduction_puts_launches_and_gaps_in_program_spans():
  events = [
      _x("user_annotation", "loop.iteration", 0, 100),
      _x("user_annotation", "agent.apply", 10, 40),
      _x("user_annotation", "loop.sample", 60, 20),
      _x("user_annotation", "portbench.train", 0, 100),   # not the program's
      _x("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
      _x("cuda_runtime", "cudaLaunchKernel", 30, 2, correlation=2),
      _x("cuda_driver", "cuLaunchKernel", 65, 2, correlation=3),
      _x("cuda_runtime", "cudaMemcpyAsync", 55, 2, correlation=4),
      _x("kernel", "k1", 20, 5, tid=7, correlation=1),
      _x("kernel", "k2", 31, 9, tid=7, correlation=2),
      _x("gpu_memcpy", "copy", 58, 2, tid=7, correlation=4),
      _x("kernel", "k3", 70, 10, tid=7, correlation=3),
      _x("kernel", "k4", 90, 5, tid=7, correlation=99),     # no launch seen
  ]
  out = spans.reduce(events, {"loop.iteration", "agent.apply", "loop.sample"},
                     {"loop.iteration"})
  assert out["launched"] == {"agent.apply": 2, "loop.iteration": 1,
                             "loop.sample": 1, spans.OUTSIDE: 1}
  # Gaps: 25-31 (middle 28, agent.apply), 40-58 (49, agent.apply), 60-70
  # (65, loop.sample), 80-90 (85, loop.iteration).
  assert out["idle"] == pytest.approx({"agent.apply": 24e-6,
                                       "loop.sample": 10e-6,
                                       "loop.iteration": 10e-6})
  assert out["idle_below_request"] == pytest.approx(34 / 44)
  assert spans.reduce([], set(), set())["idle_below_request"] is None


def test_per_unit_arithmetic_of_a_summary():
  summary = {"spans": {"loop.iteration": {"calls": 4, "total_ns": 40e6,
                                          "self_ns": 4e6},
                       "agent.apply": {"calls": 8, "total_ns": 16e6,
                                       "self_ns": 16e6}},
             "counters": {"agent.train_steps": 8}}
  assert spans.per_unit_ms(summary, "agent.apply", "iterations") == 4.0
  assert spans.per_unit_ms(summary, "agent.apply", "train_steps") == 2.0
  assert spans.per_unit_ms(summary, "loop.iteration", "train_steps",
                           "self_ns") == 0.5
  assert spans.per_unit_ms(summary, "agent.apply", "calls") is None
  assert spans.per_unit_ms(summary, "agent.grad", "iterations") is None


@pytest.mark.parametrize("cell,units", [
    ("dqn_mnih15.fused_b128", (200, 20)),
    ("sac_haarnoja18.fused_utd1", (12, 1)),
    ("dqn_mnih15.act_b1", (2000, 200))])
def test_each_traffic_file_gives_its_stretches(cell, units):
  assert spans.stretch_units(harness.cell_spec(cell)["traffic"]) == units


def test_a_traffic_file_may_state_its_own_stretches():
  traffic = {"kind": "fused_loop", "profile_iterations": 50}
  assert spans.stretch_units(traffic) == (200, 20)
  assert spans.stretch_units({**traffic, "span_stretches": [30, 3]}) == \
      (30, 3)
  assert spans.stretch_units({"kind": "fused_loop"}) is None


def _run(cell):
  return harness.Run(harness.cell_spec(cell), SEED, 0.5, True, "cpu",
                     fields=TINY[cell])


def _read_all(run, cell, monkeypatch):
  """Every new reader of `cell` on `run`, as on the card (the CPU's
  numbers are no device metric: a test reads them, no result line)."""
  monkeypatch.setattr(harness.Run, "on_card", property(lambda self: True))
  run.sync = lambda: None
  run.window = {"seconds": 1.0, "iterations": 10, "calls": 10}
  out = {name: harness.reader(name).read(run) for name in NEW[cell]}
  monkeypatch.undo()
  return out


@pytest.mark.parametrize("cell", ["dqn_mnih15.fused_b128",
                                  "sac_haarnoja18.fused_utd1"])
def test_the_stretches_divide_a_tiny_loops_iteration(cell):
  run = _run(cell)
  loop, _ = run.adapter.build(run.config, run.device)
  state = loop.init(draws=inputs.SeededDraws(SEED, run.device),
                    initial_collect_steps=8)
  run.probes.update(loop=loop, box={"state": state})
  recorded = spans.record_stretch(run, 3)
  summary = recorded["summary"]
  assert summary["spans"]["loop.iteration"]["calls"] == 3
  assert summary["counters"]["agent.train_steps"] == 3 * loop.train_steps
  assert summary["spans"]["replay.insert"]["calls"] == 3 * loop.collect_steps
  parts = sum(spans.per_unit_ms(summary, s, "iterations") for s in DIVIDE)
  parts += spans.per_unit_ms(summary, "loop.iteration", "iterations",
                             "self_ns")
  assert parts == pytest.approx(
      spans.per_unit_ms(summary, "loop.iteration", "iterations"))
  assert parts <= recorded["wall_ns"] / 1e6 / 3
  profiled = spans.profile_stretch(run, 1)
  # The CPU has no device operations to put down.
  assert profiled["launched"] == {} and profiled["idle"] == {}
  assert profiled["summary"]["counters"]["agent.train_steps"] == \
      loop.train_steps
  assert run.probes["box"]["state"].agent_state.train_step == \
      state.agent_state.train_step + 4 * loop.train_steps


@pytest.mark.parametrize("cell", ["dqn_mnih15.fused_b128",
                                  "sac_haarnoja18.fused_utd1"])
def test_the_readers_share_one_pair_of_stretches(cell, monkeypatch):
  run = _run(cell)
  loop, _ = run.adapter.build(run.config, run.device)
  state = loop.init(draws=inputs.SeededDraws(SEED, run.device),
                    initial_collect_steps=8)
  run.probes.update(loop=loop, box={"state": state})
  got = _read_all(run, cell, monkeypatch)
  launches = [n for n in got if n.startswith("apply_launches")]
  # No device operation on the CPU: nothing launched to count.
  assert [got.pop(n) for n in launches] == [None]
  assert all(v is not None and v > 0 for v in got.values()), got
  # A plain stretch, the recorded one and the profiled one, each once.
  recorded, profiled = spans.stretch_units(run.traffic)
  assert run.probes["box"]["state"].agent_state.train_step == \
      state.agent_state.train_step + (2 * recorded + profiled) * \
      loop.train_steps
  assert spans.stretches(run) is run.probes["spans"]


def test_the_stretches_divide_an_act_call(monkeypatch):
  from agents_tpu_torch.policies.policy_saver import PolicySaver

  run = _run("dqn_mnih15.act_b1")
  loop, hp = run.adapter.build(run.config, run.device)
  policy, params = run.adapter.policy(loop)
  export_dir = tempfile.mkdtemp(prefix="portbench_spans_test_")
  try:
    PolicySaver(policy).save(export_dir, params)
    exported = drive._load_loader(export_dir).ExportedPolicy(
        export_dir, platform="cpu")
    shape = (hp["pixels_size"], hp["pixels_size"], hp["pixels_frames"])
    pool = inputs.observation_pool(SEED, 4, shape).reshape((4, 1) + shape)
    run.probes.update(exported=exported, pool=pool)
    before = exported.action([pool[0]])[0][0]
    recorded = spans.record_stretch(run, 6)
    assert exported.span_hook is None
    assert np.array_equal(exported.action([pool[0]])[0][0], before)
    got = _read_all(run, "dqn_mnih15.act_b1", monkeypatch)
    assert all(v is not None and v > 0 for v in got.values()), got
  finally:
    shutil.rmtree(export_dir, ignore_errors=True)
  summary = recorded["summary"]
  assert {n: s["calls"] for n, s in summary["spans"].items()} == {
      "act.call": 6, "act.prep": 6, "act.upload": 6, "act.program": 6,
      "act.fetch": 6}
  parts = sum(spans.per_unit_ms(summary, f"act.{p}", "calls")
              for p in ("prep", "upload", "program", "fetch"))
  assert 0 < parts <= spans.per_unit_ms(summary, "act.call", "calls")


@pytest.mark.parametrize("cell", sorted(NEW))
def test_span_readers_give_nothing_on_a_cpu_run(cell):
  spec = harness.cell_spec(cell)
  assert set(NEW[cell]) <= {m["name"] for m in spec["per_layer"]}
  run = harness.execute(cell, SEED, 0.5, True, device="cpu",
                        fields=TINY[cell])
  assert not set(NEW[cell]) & set(run.layer_metrics)
  line = harness.result_line(run)
  assert line["correct"] is True and line["metrics"] == {}
