"""The port's offline pipeline learns on the CPU: `examples/
cql_sac_offline_torch.py`'s defaults (the size of `tests/
test_cql_offline_e2e.py`) end to end with the dataset in a temporary
directory.

It takes about two minutes on 8 CPU cores, past the tier-1 budget, so it
is marked slow: run it with

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cql_offline_pipeline.py -m slow

The bars: the behaviour policy beats -1,000 and the policy after the BC
steps -500 (`tests/test_cql_offline_e2e.py:66, :147`); after 3,000 steps
the CQL policy beats -900, the worst of the JAX package's own four phase-C
seeds at this config (-898.7; `tests/test_torch_reference_bars.py`), where
the JAX test's -700 holds at three of the four.
"""
import math

import pytest

from examples.cql_sac_offline_torch import Config, train_eval


@pytest.mark.slow
def test_offline_pipeline_learns_on_cpu(tmp_path):
  out = train_eval(Config(root_dir=str(tmp_path), device="cpu"))
  assert out["behavior_return"] > -1000.0, out
  assert out["bc_phase_return"] > -500.0, out
  assert out["offline_return"] > -900.0, out
  assert out["eval_episodes"] == 10 and math.isfinite(out["last_loss"])
