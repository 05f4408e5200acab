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
EXAMPLES = ("dqn_cartpole_torch.py", "dqn_pixels_torch.py",
            "sac_pendulum_torch.py", "ppo_cartpole_torch.py")


def _port_modules():
  return sorted(m.name for m in pkgutil.walk_packages(
      agents_tpu_torch.__path__, prefix="agents_tpu_torch."))


def _port_sources():
  pkg = os.path.join(ROOT, "agents_tpu_torch")
  files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
           if f.endswith(".py")]
  return sorted(files) + [os.path.join(ROOT, "chip_smoke.py")] + [
      os.path.join(ROOT, "examples", name) for name in EXAMPLES]


def _forbidden(name):
  return name.split(".")[0] in FORBIDDEN


def test_port_imports_leave_jax_and_agents_tpu_unloaded():
  modules = _port_modules()
  for name in ("train.fused_loop", "environments.classic.synthetic_pixels",
               "environments.classic.catch",
               "agents.categorical_dqn.categorical_dqn_agent",
               "environments.classic.pendulum", "agents.sac.sac_agent",
               "networks.actor_distribution_network",
               "networks.projection_networks", "networks.value_network",
               "policies.actor_policy", "utils.value_ops",
               "utils.tensor_normalizer", "agents.ppo.ppo_agent",
               "agents.ppo.ppo_policy", "agents.ppo.ppo_variants",
               "agents.reinforce.reinforce_agent", "train.on_policy_loop",
               "eval.metric_utils"):
    assert f"agents_tpu_torch.{name}" in modules
  modules += [f"examples.{name[:-3]}" for name in EXAMPLES]
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
  assert len(sources) > 45
  offending = {os.path.relpath(p, ROOT): bad for p in sources
               if (bad := [n for n in _imported_names(p) if _forbidden(n)])}
  assert offending == {}


def test_entry_points_raise_without_a_card(monkeypatch):
  """The default device is "cuda"; with no card they raise instead of
  running on the CPU."""
  from agents_tpu_torch.agents.categorical_dqn import CategoricalDqnAgent
  from agents_tpu_torch.agents.dqn import DqnAgent
  from agents_tpu_torch.agents.ppo import PPOAgent
  from agents_tpu_torch.agents.reinforce import ReinforceAgent
  from agents_tpu_torch.agents.sac import SacAgent
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import (CartPole, Catch,
                                                     Pendulum,
                                                     SyntheticPixels)
  from agents_tpu_torch.networks import (make_actor_distribution_network,
                                         make_categorical_q_network,
                                         make_critic_network, make_q_network,
                                         make_sac_actor_network,
                                         make_value_network)
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.train import FusedTrainLoop, OnPolicyTrainLoop
  from agents_tpu_torch.trajectories import trajectory as tj

  env = BatchedTorchEnv(CartPole(), 4, device="cpu")
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = make_q_network(tss.observation, asp, fc_layer_params=(8,),
                        device="cpu")
  agent = DqnAgent(tss, asp, qnet, torch.optim.Adam, device="cpu")
  replay = UniformReplay(tj.trajectory_spec(tss, asp), 4, 8, device="cpu")
  pixels = SyntheticPixels(size=12)
  pobs, pact = pixels.observation_spec(), pixels.action_spec()
  c51net = make_categorical_q_network(pobs, pact, num_atoms=5,
                                      conv_layer_params=((4, 3, 2),),
                                      device="cpu")
  pendulum = Pendulum()
  sobs, sact = pendulum.observation_spec(), pendulum.action_spec()
  actor = make_sac_actor_network(sobs, sact, (8,), device="cpu")
  critic = make_critic_network(sobs, sact, joint_fc_layer_params=(8,),
                               device="cpu")
  ppo_actor = make_actor_distribution_network(tss.observation, asp, (), (8,),
                                              device="cpu")
  ppo_value = make_value_network(tss.observation, (8,), device="cpu")
  ppo = PPOAgent(tss, asp, torch.optim.Adam, ppo_actor, ppo_value,
                 device="cpu")

  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  for build in (lambda: BatchedTorchEnv(CartPole(), 4),
                lambda: BatchedTorchEnv(pixels, 4),
                lambda: BatchedTorchEnv(Catch(), 4),
                lambda: make_q_network(tss.observation, asp),
                lambda: make_q_network(pobs, pact, ((4, 3, 2),),
                                       dueling=True),
                lambda: make_categorical_q_network(pobs, pact),
                lambda: CategoricalDqnAgent(tss, pact, c51net,
                                            torch.optim.Adam),
                lambda: DqnAgent(tss, asp, qnet, torch.optim.Adam),
                lambda: BatchedTorchEnv(pendulum, 4),
                lambda: make_sac_actor_network(sobs, sact),
                lambda: make_critic_network(sobs, sact),
                lambda: SacAgent(tss, sact, critic, actor, torch.optim.Adam,
                                 torch.optim.Adam, torch.optim.Adam),
                lambda: UniformReplay(tj.trajectory_spec(tss, asp), 4, 8),
                lambda: FusedTrainLoop(env, agent, replay),
                lambda: make_actor_distribution_network(tss.observation, asp),
                lambda: make_value_network(tss.observation),
                lambda: PPOAgent(tss, asp, torch.optim.Adam, ppo_actor,
                                 ppo_value),
                lambda: ReinforceAgent(tss, asp, ppo_actor,
                                       torch.optim.Adam),
                lambda: OnPolicyTrainLoop(env, ppo)):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      build()


def test_example_raises_without_a_card():
  """The examples' default device is "cuda" too."""
  for example in EXAMPLES:
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            f"sys.path.insert(0, {os.path.join(ROOT, 'examples')!r})\n"
            f"import {example[:-3]} as ex\n"
            "ex.build_loop(ex.Config())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0, example
    assert "torch.cuda.is_available() is False" in out.stderr, example

