"""The port stands alone: no module of `agents_tpu_torch`, nor `chip_smoke.py`
or the port's example, imports JAX, flax, optax or `agents_tpu`; and its
entry points refuse to fall back to the CPU when no card is present."""
import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import agents_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "agents_tpu")


def _port_modules():
  return sorted(m.name for m in pkgutil.walk_packages(
      agents_tpu_torch.__path__, prefix="agents_tpu_torch."))


def _port_sources():
  pkg = os.path.join(ROOT, "agents_tpu_torch")
  files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
           if f.endswith(".py")]
  return sorted(files) + [os.path.join(ROOT, "chip_smoke.py"),
                          os.path.join(ROOT, "examples",
                                       "dqn_cartpole_torch.py")]


def _forbidden(name):
  return name.split(".")[0] in FORBIDDEN


def test_port_imports_leave_jax_and_agents_tpu_unloaded():
  modules = _port_modules()
  assert "agents_tpu_torch.train.fused_loop" in modules
  code = ("import importlib, json, sys\n"
          f"for m in {modules!r}: importlib.import_module(m)\n"
          "print(json.dumps(sorted(sys.modules)))")
  out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": ROOT})
  assert out.returncode == 0, out.stderr
  loaded = [m for m in json.loads(out.stdout) if _forbidden(m)]
  assert loaded == []


def _imported_names(path):
  tree = ast.parse(open(path).read(), filename=path)
  names = []
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      names += [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
      names.append(node.module)
    elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
          == "import_module" and node.args
          and isinstance(node.args[0], ast.Constant)):
      names.append(node.args[0].value)
  return names


def test_port_sources_name_no_forbidden_import():
  sources = _port_sources()
  assert len(sources) > 40
  offending = {os.path.relpath(p, ROOT): bad for p in sources
               if (bad := [n for n in _imported_names(p) if _forbidden(n)])}
  assert offending == {}


def test_entry_points_raise_without_a_card(monkeypatch):
  """The default device is "cuda"; with no card they raise instead of
  running on the CPU."""
  from agents_tpu_torch.agents.dqn import DqnAgent
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import CartPole
  from agents_tpu_torch.networks import make_q_network
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.train import FusedTrainLoop
  from agents_tpu_torch.trajectories import trajectory as tj

  env = BatchedTorchEnv(CartPole(), 4, device="cpu")
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = make_q_network(tss.observation, asp, fc_layer_params=(8,),
                        device="cpu")
  agent = DqnAgent(tss, asp, qnet, torch.optim.Adam, device="cpu")
  replay = UniformReplay(tj.trajectory_spec(tss, asp), 4, 8, device="cpu")

  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  for build in (lambda: BatchedTorchEnv(CartPole(), 4),
                lambda: make_q_network(tss.observation, asp),
                lambda: DqnAgent(tss, asp, qnet, torch.optim.Adam),
                lambda: UniformReplay(tj.trajectory_spec(tss, asp), 4, 8),
                lambda: FusedTrainLoop(env, agent, replay)):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      build()


def test_example_raises_without_a_card():
  """The example's default device is "cuda" too."""
  code = ("import sys, torch\n"
          "torch.cuda.is_available = lambda: False\n"
          f"sys.path.insert(0, {os.path.join(ROOT, 'examples')!r})\n"
          "import dqn_cartpole_torch as ex\n"
          "ex.build_loop(ex.Config())\n")
  out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode != 0
  assert "torch.cuda.is_available() is False" in out.stderr
