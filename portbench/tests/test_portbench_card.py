"""On the card: each cell's control, the reference put in the program's
place one precision below the configuration's (fp8 under bfloat16, TF32
under float32), comes out not correct, while the program does; and so
does each fault planted in the reference. Run on the card with
``python3 -m pytest portbench/tests -m card``."""
import pytest

from portbench import calibrate, harness

CELLS = ["dqn_mnih15.fused_b128", "sac_haarnoja18.fused_utd1",
         "dqn_mnih15.act_b1"]
SEEDS = (3100000001, 3100000002, 3100000003)


def _fails(numbers, limits):
  return [k for k, v in limits.items() if numbers[k] > v]


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_are_not_correct(cell, seed):
  import torch
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card")
  harness.tf32_off()
  limits = harness.cell_spec(cell)["limits"]
  out = calibrate.readings(cell, seed, 1.0, "cuda", True)
  assert not _fails(out["program"], limits), out["program"]
  for kind in ("control", "half_batch", "altered"):
    if kind in out:
      assert _fails(out[kind], limits), (kind, out[kind])


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_a_skipped_target_update_is_not_correct(seed):
  """At the cell's own size: the DQN's first target update past the
  followed steps, skipped, reads on `target_mismatch`."""
  import torch
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card")
  from portbench.tests.test_portbench_faults import skipped_target_update
  cell = "dqn_mnih15.fused_b128"
  run = harness.execute(cell, seed, 1.0, False, "cuda",
                        plant=skipped_target_update)
  mismatch = run.numbers["target_mismatch"]
  print(f"seed {seed}: target_mismatch {mismatch}")
  assert mismatch > harness.cell_spec(cell)["limits"]["target_mismatch"]
