"""The port's `utils/config.py` and `benchmark/return_windows.py` against
the JAX package's: the same overrides give the same configs, the JSON
round trip is the same, and the windows pass and fail on the same points.
"""
import dataclasses
import json
from typing import Tuple

import pytest

from agents_tpu.benchmark import return_windows as jwindows
from agents_tpu.utils import config as jconfig
from agents_tpu_torch.benchmark import return_windows as windows
from agents_tpu_torch.utils import config


@dataclasses.dataclass(frozen=True)
class Optim:
  lr: float = 1e-3
  name: str = "adam"
  widths: Tuple[int, ...] = (64, 64)


@dataclasses.dataclass(frozen=True)
class Cfg:
  steps: int = 10
  gamma: float = 0.99
  tag: str = "run"
  smoke: bool = False
  optim: Optim = Optim()


AGREED = [
    [],
    ["--cfg.steps=7"],
    ["--cfg.gamma=0.5", "--cfg.tag=x"],
    ["--cfg.smoke=true"],
    ["--cfg.smoke=0"],
    ["--cfg.smoke=YES"],
    ["--cfg.optim.lr=0.1", "--cfg.optim.name=sgd"],
    ["--cfg.optim.widths=8,4,2"],
    ["steps=3", "--other", "--cfg.steps=4"],   # non-override args skipped
    ["--steps=5"],                             # the prefix is optional
]


@pytest.mark.parametrize("argv", AGREED, ids=[" ".join(a) or "none"
                                              for a in AGREED])
def test_overrides_match_jax(argv):
  got = config.parse_flags(Cfg(), argv)
  want = jconfig.parse_flags(Cfg(), argv)
  assert got == want
  assert config.to_json(got) == jconfig.to_json(want)


def test_json_round_trip_matches_jax(tmp_path):
  cfg = config.apply_overrides(Cfg(), ["--cfg.optim.widths=3"])
  config.save(cfg, str(tmp_path / "port.json"))
  jconfig.save(cfg, str(tmp_path / "jax.json"))
  assert (tmp_path / "port.json").read_text() == \
      (tmp_path / "jax.json").read_text()
  assert json.loads((tmp_path / "port.json").read_text())["optim"][
      "widths"] == [3]


def test_unknown_fields_and_non_dataclasses_raise():
  for mod in (config, jconfig):
    with pytest.raises(KeyError, match="nope"):
      mod.apply_overrides(Cfg(), ["--cfg.nope=1"])
    with pytest.raises(TypeError):
      mod.apply_overrides(Cfg(), ["--cfg.steps.x=1"])


def test_bare_tuple_fields_take_their_current_layout():
  """The port's one addition: a field annotated with a bare ``tuple``
  (the examples' configs) parses like its current value."""

  @dataclasses.dataclass(frozen=True)
  class Example:
    fc_layer_params: tuple = (100, 50)
    conv_layer_params: tuple = ((32, 8, 4),)

  cfg = config.apply_overrides(Example(), [
      "--cfg.fc_layer_params=8", "--cfg.conv_layer_params=8x3x1,4x3x2"])
  assert cfg.fc_layer_params == (8,)
  assert cfg.conv_layer_params == ((8, 3, 1), (4, 3, 2))


POINTS = [(1000, 20.0), (30_000, 150.0), (64_000, 198.0), (90_000, 201.0)]


@pytest.mark.parametrize("name", [
    "SAC_HALFCHEETAH_WINDOWS", "DQN_PONG_WINDOWS", "PPO_HALFCHEETAH_WINDOWS",
    "PPO_HOPPER_WINDOWS", "PPO_WALKER2D_WINDOWS",
    "CQL_HALFCHEETAH_MEDIUM_WINDOWS", "DQN_CARTPOLE_WINDOWS"])
def test_check_windows_match_jax(name):
  mine, theirs = getattr(windows, name), getattr(jwindows, name)
  assert [dataclasses.astuple(w) for w in mine] == [
      dataclasses.astuple(w) for w in theirs]
  for points in (POINTS, POINTS[:1], []):
    assert windows.check_windows(points, mine) == jwindows.check_windows(
        points, theirs)


@pytest.mark.parametrize("name", [
    "DQN_CARTPOLE_REFERENCE_LIVE", "PPO_CARTPOLE_LIVE", "SAC_PENDULUM_LIVE",
    "CATCH_CONV_LIVE"])
def test_live_windows_match_jax(name):
  mine, theirs = getattr(windows, name), getattr(jwindows, name)
  assert dataclasses.astuple(mine) == dataclasses.astuple(theirs)
  passing = [(mine.step_budget, mine.min_return)]
  failing = [(mine.step_budget + 1, mine.min_return + 1.0),
             (mine.step_budget, mine.min_return - 1.0)]
  assert windows.assert_live_window(passing, mine)
  assert jwindows.assert_live_window(passing, theirs)
  for mod, w in ((windows, mine), (jwindows, theirs)):
    with pytest.raises(AssertionError):
      mod.assert_live_window(failing, w)


def test_read_jsonl_returns_and_assert_windows(tmp_path):
  log = tmp_path / "train.jsonl"
  log.write_text("\n".join([
      '{"step": 1000, "AverageReturn": 20.0}', "not json",
      '{"step": 64000, "AverageReturn": 198.0}',
      '{"step": 64000, "loss": 1.0}']))
  pts = windows.read_jsonl_returns(str(log))
  assert pts == jwindows.read_jsonl_returns(str(log)) == [
      (1000, 20.0), (64000, 198.0)]
  assert windows.assert_windows(pts, windows.DQN_CARTPOLE_WINDOWS)
  with pytest.raises(AssertionError):
    windows.assert_windows(pts, (windows.ReturnWindow(1000, 100.0, 200.0),))
  tol = (windows.ReturnWindow(50_000, 0.0, 300.0, tolerance_steps=100),)
  assert windows.check_windows(pts, tol) == jwindows.check_windows(
      pts, (jwindows.ReturnWindow(50_000, 0.0, 300.0, tolerance_steps=100),))
