"""One adapter per program the benchmark drives: how a configuration file
builds it, hands it the benchmark's inputs, reads its state and which
reference (`REFERENCE`) judges it."""
import dataclasses
import importlib


def _tuples(value):
  return tuple(_tuples(v) for v in value) if isinstance(value, list) \
      else value


def build_example(entry: str, config: dict, device):
  """(loop, cfg, hyperparameters): the example module `entry`'s
  `build_loop` over its `Config` at the file's fields, and those fields
  with the constants the file states for the reference."""
  module = importlib.import_module(entry)
  fields = {k: _tuples(v) for k, v in config["fields"].items()}
  cfg = module.Config(**fields, device=str(device))
  hp = dataclasses.asdict(cfg)
  hp.update(config.get("stated", {}), peak=config["peak"])
  return module.build_loop(cfg), cfg, hp
