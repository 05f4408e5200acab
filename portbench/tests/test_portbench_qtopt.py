"""The QT-Opt cell (`qtopt_kalashnikov18.cem64_b32`): its files, its
adapter against the plain reference, what the reference imports, the
counting of `portbench/qtopt.py`, and, on the CPU at a tiny size, a sound
run against faults planted in the program: CEM's features shifted by a
row, and one CEM round in place of two."""
import math
import os
import subprocess
import sys

import pytest

from agents_tpu_torch.policies.cem_policy import CEMPolicy
from portbench import flops, harness, qtopt
from portbench.programs import qtopt_grasping
from portbench.reference import qtopt as reference
from portbench.tests._tiny import SEED

CELL = "qtopt_kalashnikov18.cem64_b32"
TINY = {"image_size": 32, "torso_conv_layer_params": [[4, 6, 2], [4, 5, 1]],
        "torso_padding": ["VALID", "SAME"], "torso_max_pools": [[0, 3, 3]],
        "merge_fc_layer_params": [8, 4],
        "head_conv_layer_params": [[4, 3, 1], [4, 3, 1]],
        "head_max_pools": [[0, 2, 2]], "head_fc_layer_params": [8],
        "cem_num_samples": 8, "cem_num_elites": 2, "env_batch_size": 4,
        "sample_batch_size": 4, "replay_capacity": 64,
        "initial_collect_steps": 8, "target_update_period": 5,
        "delayed_target_update_period": 2}
NEW = ("cem_span_ms.env_steps", "cem_launches.env_steps",
       "cem_candidates_per_image.env_steps", "cem_roofline.env_steps")


def _hp(fields=None):
  spec = harness.cell_spec(CELL)
  return {**spec["config"]["fields"], **(fields or {})}


def test_the_cells_files_load():
  spec = harness.cell_spec(CELL)
  assert spec["cell"]["chips"] == 1
  assert spec["traffic"]["kind"] == "fused_loop"
  assert spec["traffic"]["span_stretches"] == [10, 2]
  assert spec["config"]["program"] == "qtopt_grasping"
  assert (spec["config"]["peak"], spec["config"]["control"]) == ("fp32",
                                                                 "tf32")
  names = {m["name"] for m in spec["per_layer"]}
  assert set(NEW) <= names
  assert "conv_kernel_roofline.env_steps" not in names
  assert [m["name"] for m in spec["end_to_end"]] == ["env_steps_per_s",
                                                     "setup_s"]
  hp = _hp()
  assert hp["env_batch_size"] * hp["replay_capacity"] == 64_000
  assert spec["config"]["widths"]["parameters"] == sum(
      math.prod(s) for _, s, _, _ in reference.leaves(hp)) == 1_669_889


def test_the_adapters_leaves_are_the_programs_parameters():
  run = harness.Run(harness.cell_spec(CELL), SEED, 0.1, False, "cpu",
                    fields=TINY)
  loop, hp = run.adapter.build(run.config, run.device)
  params = qtopt_grasping._canonical(hp, loop.agent.q_network)
  shapes = {name: tuple(shape) for name, shape, _, _ in
            reference.leaves(hp)}
  assert list(params) == list(shapes)
  assert {n: tuple(p.shape) for n, p in params.items()} == shapes


def test_the_reference_imports_nothing_forbidden():
  code = ("import sys\n"
          "from portbench.reference import qtopt\n"
          "print(sorted({m.split('.')[0] for m in sys.modules} & "
          "{'agents_tpu', 'agents_tpu_torch', 'examples', 'jax', 'flax'}))\n")
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=harness.ROOT,
                       env=dict(os.environ, PYTHONPATH=harness.ROOT))
  assert out.returncode == 0, out.stderr[-3000:]
  assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_counts_of_the_published_configuration():
  hp = _hp()
  torso, head = qtopt.forward_flops(hp)
  assert torso == 8_232_966_144 and head == 337_851_520
  assert qtopt.candidates_per_row(hp) == 129
  assert round(qtopt.iteration_flops(hp) / 1e12, 3) == 4.663
  peak = flops.PEAKS["fp32"]
  conv = qtopt.conv_least_s_per_iteration(hp, peak)
  cem = qtopt.cem_least_s_per_iteration(hp, peak)
  # The convolutions are nearly all of the model FLOPs; CEM's two calls
  # are 71% of them, and their pools add bytes to the least time.
  assert 0.9 < conv * peak / qtopt.iteration_flops(hp) <= 1.0
  cem_flops = 64 * (torso + 129 * head)
  assert round(cem_flops / qtopt.iteration_flops(hp), 2) == 0.71
  assert cem_flops / peak <= cem < 1.05 * cem_flops / peak


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


def shifted_features(loop):
  loop.agent.policy._features = (
      lambda params, obs: CEMPolicy._features(params, obs).roll(1, 0))


def one_iteration(loop):
  loop.agent.policy.num_iterations = 1


@pytest.mark.parametrize("plant", [shifted_features, one_iteration],
                         ids=lambda p: p.__name__)
def test_a_planted_fault_is_not_correct(plant):
  line = _run(plant)
  assert line["correct"] is False, line["checks"]
