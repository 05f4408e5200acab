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
            "sac_pendulum_torch.py", "ppo_cartpole_torch.py",
            "td3_pendulum_torch.py", "cql_sac_offline_torch.py",
            "sac_halfcheetah_torch.py", "ppo_halfcheetah_torch.py",
            "sac_train_job_torch.py", "sac_collect_job_torch.py",
            "eval_job_torch.py", "bandits_train_eval_torch.py",
            "dqn_atari_torch.py", "cql_sac_offline_host_torch.py")
# The distributed SAC jobs and the eval job build no `Config`: the learner
# and the eval job are checked on their own below, and the collector runs
# on the CPU by design.
JOBS = ("sac_train_job_torch.py", "sac_collect_job_torch.py",
        "eval_job_torch.py")
# The export, eval and orchestration modules.
ORCHESTRATION_MODULES = (
    "utils.config", "networks.registry", "policies.registry",
    "policies.torch_export", "policies.policy_saver", "policies.policy_utils",
    "metrics.export_utils", "train.triggers", "train.train_utils",
    "train.learner", "train.actor", "benchmark.return_windows")
HOST_MODULES = (
    "environments.py_environment", "environments.test_envs",
    "environments.utils", "environments.wrappers",
    "environments.gym_wrapper", "environments.suite_gym",
    "environments.batched_py_environment",
    "environments.parallel_py_environment", "metrics.py_metrics",
    "policies.jitted_py_policy", "drivers.py_driver", "eval.metric_utils",
    "train.host_device_loop", "train.host_on_policy_loop",
    "train.async_host_device_loop", "replay_buffers.rate_limiter",
    "replay_buffers.prioritized_replay", "replay_buffers.episodic_replay",
    "replay_buffers.py_uniform_replay", "replay_buffers.host_ingest",
    "train.variable_container", "utils.native_build")
# TensorBoard, profiling, observers, composite arrays, the dm_env suites,
# golden trajectories and data parallelism.
SLICE_11_MODULES = (
    "utils.tb_writer", "utils.observers", "utils.composite",
    "utils.profiling", "environments.dm_env_wrapper", "environments.suites",
    "environments.suite_dm_control", "environments.trajectory_replay",
    "parallel.distributed", "parallel.mesh_utils")
# The bandits (every module of `agents_tpu/bandits`).
BANDIT_MODULES = (
    "bandits.agents.linear_bandit_agent",
    "bandits.agents.neural_bandit_agents",
    "bandits.agents.mixture_and_ranking_agents",
    "bandits.environments.bandit_envs",
    "bandits.environments.dataset_utilities",
    "bandits.environments.environment_utilities",
    "bandits.environments.movielens",
    "bandits.environments.nonstationary_envs",
    "bandits.environments.structured_envs",
    "bandits.metrics.bandit_metrics", "bandits.multi_objective.scalarizer",
    "bandits.networks.global_and_arm_feature_network",
    "bandits.policies.constraints", "bandits.policies.linalg",
    "bandits.policies.linear_bandit_policy",
    "bandits.specs.bandit_spec_utils")
# The port's modules outside its package, beside `chip_smoke.py`.
ROOT_MODULES = ("torch_dryrun", "bench_torch")


def _port_modules():
  return sorted(m.name for m in pkgutil.walk_packages(
      agents_tpu_torch.__path__, prefix="agents_tpu_torch."))


def _port_sources():
  pkg = os.path.join(ROOT, "agents_tpu_torch")
  files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
           if f.endswith(".py")]
  return sorted(files) + [os.path.join(ROOT, f"{name}.py") for name in
                          ("chip_smoke",) + ROOT_MODULES] + [
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
               "eval.metric_utils", "agents.td3.td3_agent",
               "agents.ddpg.ddpg_agent", "agents.cql.cql_sac_agent",
               "agents.behavioral_cloning.behavioral_cloning_agent",
               "agents.random.random_agent", "policies.random_policy",
               "policies.wrappers", "utils.dataset_io",
               "agents.qtopt.qtopt_agent", "policies.cem_policy",
               "policies.cem_samplers", "networks.sequential",
               "environments.classic.acrobot",
               "environments.classic.mountain_car",
               "environments.torch_wrappers", "networks.lstm_networks",
               "train.checkpointer") + (HOST_MODULES + ORCHESTRATION_MODULES
                                        + SLICE_11_MODULES + BANDIT_MODULES):
    assert f"agents_tpu_torch.{name}" in modules
  modules += [f"examples.{name[:-3]}" for name in EXAMPLES] + list(
      ROOT_MODULES)
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
  assert len(sources) > 70
  offending = {os.path.relpath(p, ROOT): bad for p in sources
               if (bad := [n for n in _imported_names(p) if _forbidden(n)])}
  assert offending == {}


def test_entry_points_raise_without_a_card(monkeypatch):
  """The default device is "cuda"; with no card they raise instead of
  running on the CPU."""
  from agents_tpu_torch.agents.behavioral_cloning import \
      BehavioralCloningAgent
  from agents_tpu_torch.agents.categorical_dqn import CategoricalDqnAgent
  from agents_tpu_torch.agents.cql import CqlSacAgent
  from agents_tpu_torch.agents.ddpg import DdpgAgent
  from agents_tpu_torch.agents.dqn import DqnAgent
  from agents_tpu_torch.agents.ppo import PPOAgent
  from agents_tpu_torch.agents.qtopt import QtOptAgent
  from agents_tpu_torch.agents.reinforce import ReinforceAgent
  from agents_tpu_torch.agents.random import RandomAgent
  from agents_tpu_torch.agents.sac import SacAgent
  from agents_tpu_torch.agents.td3 import Td3Agent
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import (Acrobot, CartPole,
                                                     Catch,
                                                     ContinuousMountainCar,
                                                     MountainCar, Pendulum,
                                                     SyntheticPixels)
  from agents_tpu_torch.networks import (BiasLayer,
                                         make_actor_distribution_network,
                                         make_categorical_q_network,
                                         make_critic_network,
                                         make_deterministic_actor_network,
                                         make_q_network, make_q_rnn_network,
                                         make_sac_actor_network,
                                         make_value_network,
                                         make_value_rnn_network)
  from agents_tpu_torch.networks import \
      make_actor_distribution_rnn_network as make_actor_rnn
  from agents_tpu_torch.replay_buffers import (PrioritizedReplay,
                                               UniformReplay)
  import torch_dryrun as dryrun
  from agents_tpu_torch.parallel import create_mesh
  from agents_tpu_torch.replay_buffers.episodic_replay import EpisodicReplay
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
  det_actor = make_deterministic_actor_network(sobs, sact, (8,), device="cpu")
  rnn = dict(input_fc_layer_params=(4,), lstm_size=4)
  qrnn = make_q_rnn_network(tss.observation, asp, **rnn, device="cpu")
  actor_rnn = make_actor_rnn(tss.observation, asp, **rnn, device="cpu")
  value_rnn = make_value_rnn_network(tss.observation, **rnn, device="cpu")

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
                lambda: OnPolicyTrainLoop(env, ppo),
                lambda: make_deterministic_actor_network(sobs, sact),
                lambda: Td3Agent(tss, sact, det_actor, critic,
                                 torch.optim.Adam, torch.optim.Adam),
                lambda: DdpgAgent(tss, sact, det_actor, critic,
                                  torch.optim.Adam, torch.optim.Adam),
                lambda: CqlSacAgent(tss, sact, critic, actor,
                                    torch.optim.Adam, torch.optim.Adam,
                                    torch.optim.Adam),
                lambda: BehavioralCloningAgent(tss, sact, actor,
                                               torch.optim.Adam),
                lambda: RandomAgent(tss, sact),
                lambda: QtOptAgent(tss, sact, critic, torch.optim.Adam),
                lambda: BatchedTorchEnv(Acrobot(), 4),
                lambda: BatchedTorchEnv(MountainCar(), 4),
                lambda: BatchedTorchEnv(ContinuousMountainCar(), 4),
                lambda: BiasLayer(4),
                lambda: make_q_rnn_network(tss.observation, asp),
                lambda: make_value_rnn_network(tss.observation),
                lambda: make_actor_rnn(tss.observation, asp),
                lambda: DqnAgent(tss, asp, qrnn, torch.optim.Adam,
                                 train_sequence_length=4),
                lambda: PPOAgent(tss, asp, torch.optim.Adam, actor_rnn,
                                 value_rnn),
                lambda: PrioritizedReplay(tj.trajectory_spec(tss, asp), 4, 8),
                lambda: FusedTrainLoop(env, agent, PrioritizedReplay(
                    tj.trajectory_spec(tss, asp), 4, 8, device="cpu")),
                lambda: EpisodicReplay(tj.trajectory_spec(tss, asp), 4, 9,
                                       5),
                lambda: create_mesh(),
                lambda: dryrun.build_fused_loop(batch_size=4, capacity=8,
                                                sample_batch_size=4, fc=(8,)),
                lambda: dryrun.build_ppo_loop(
                    batch_size=4, rollout_length=3, num_epochs=1,
                    num_minibatches=1, num_minibatch_shards=1, fc=(8,))):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      build()


def test_example_raises_without_a_card():
  """The examples' default device is "cuda" too (the offline example
  builds its environment first)."""
  for example in EXAMPLES:
    if example in JOBS:
      continue
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            f"sys.path.insert(0, {os.path.join(ROOT, 'examples')!r})\n"
            f"import {example[:-3]} as ex\n"
            "(getattr(ex, 'build_loop', None) or ex.build_env)(ex.Config())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0, example
    assert "torch.cuda.is_available() is False" in out.stderr, example



def test_train_job_raises_without_a_card():
  """The distributed SAC learner defaults to "cuda" and raises without a
  card before it creates a ring; `--device cpu` runs it on the CPU."""
  code = ("import sys, torch\n"
          "torch.cuda.is_available = lambda: False\n"
          f"sys.path.insert(0, {ROOT!r})\n"
          "from examples import sac_train_job_torch as job\n"
          "from agents_tpu_torch.environments.test_envs import "
          "RandomPyEnvironment\n"
          "from agents_tpu_torch.specs import array_spec\n"
          "import numpy as np\n"
          "env = RandomPyEnvironment(array_spec.ArraySpec((3,), np.float32),"
          " array_spec.BoundedArraySpec((1,), np.float32, -2, 2))\n"
          "job.Learner(job.parse_args(['--rings=never_created']),"
          " env.time_step_spec(), env.action_spec())\n")
  out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
  assert out.returncode != 0
  assert "torch.cuda.is_available() is False" in out.stderr


def test_host_modules_import_without_gymnasium():
  """The host modules and the HalfCheetah examples import where gymnasium
  cannot be imported (it is imported inside `suite_gym.load` and
  `spec_from_gym_space` only)."""
  names = [f"agents_tpu_torch.{m}" for m in HOST_MODULES] + [
      "examples.sac_halfcheetah_torch", "examples.ppo_halfcheetah_torch",
      "examples.sac_train_job_torch", "examples.sac_collect_job_torch"]
  code = ("import importlib, json, sys\n"
          "sys.modules['gymnasium'] = None\n"
          f"for m in {names!r}: importlib.import_module(m)\n"
          "print(json.dumps(sorted(sys.modules)))")
  out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": ROOT})
  assert out.returncode == 0, out.stderr
  loaded = json.loads(out.stdout)
  assert [m for m in loaded if _forbidden(m)] == []
  assert "mujoco" not in loaded


def test_host_entry_points_raise_without_a_card(monkeypatch):
  """The host loops and `JittedPyPolicy` default to "cuda" and raise
  without a card unless given "cpu"."""
  import numpy as np

  from agents_tpu_torch.agents.sac import SacAgent
  from agents_tpu_torch.environments.batched_py_environment import \
      BatchedPyEnvironment
  from agents_tpu_torch.environments.test_envs import RandomPyEnvironment
  from agents_tpu_torch.networks import (make_critic_network,
                                         make_sac_actor_network)
  from agents_tpu_torch.policies.jitted_py_policy import JittedPyPolicy
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.specs import array_spec
  from agents_tpu_torch.train import (AsyncHostDeviceTrainLoop,
                                      HostDeviceTrainLoop,
                                      HostOnPolicyTrainLoop)
  from agents_tpu_torch.trajectories import trajectory as tj

  obs = array_spec.ArraySpec((3,), np.float32)
  act = array_spec.BoundedArraySpec((1,), np.float32, -1, 1)
  env = BatchedPyEnvironment([RandomPyEnvironment(obs, act)], False)
  tss = env.time_step_spec()
  agent = SacAgent(tss, act,
                   make_critic_network(obs, act, joint_fc_layer_params=(4,),
                                       device="cpu"),
                   make_sac_actor_network(obs, act, (4,), device="cpu"),
                   torch.optim.Adam, torch.optim.Adam, torch.optim.Adam,
                   device="cpu")
  replay = UniformReplay(tj.trajectory_spec(tss, act), 1, 8, device="cpu")
  for build in (lambda d: HostDeviceTrainLoop(env, agent, replay, device=d),
                lambda d: AsyncHostDeviceTrainLoop(env, agent, replay,
                                                   device=d),
                lambda d: HostOnPolicyTrainLoop(env, agent, device=d),
                lambda d: JittedPyPolicy(agent.policy, device=d)):
    assert build("cpu").device.type == "cpu"
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  for build in (lambda: HostDeviceTrainLoop(env, agent, replay),
                lambda: AsyncHostDeviceTrainLoop(env, agent, replay),
                lambda: HostOnPolicyTrainLoop(env, agent),
                lambda: JittedPyPolicy(agent.policy)):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      build()


def test_export_and_eval_entry_points_raise_without_a_card(tmp_path,
                                                          monkeypatch):
  """`load_policy`, the eval job and `make_encoding_network` default to
  "cuda" and raise without a card; a saver without a card exports the
  CPU program alone."""
  from agents_tpu_torch.environments.classic import CartPole
  from agents_tpu_torch.networks import make_q_network
  from agents_tpu_torch.networks.encoding_network import \
      make_encoding_network
  from agents_tpu_torch.policies import GreedyPolicy, QPolicy
  from agents_tpu_torch.policies.policy_saver import (PolicySaver,
                                                      load_policy)
  from agents_tpu_torch.trajectories import time_step as ts
  from examples import eval_job_torch

  env = CartPole()
  tss = ts.time_step_spec(env.observation_spec())
  qnet = make_q_network(tss.observation, env.action_spec(),
                        fc_layer_params=(4,), device="cpu")
  export = tmp_path / "policies" / "greedy_policy"
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  PolicySaver(GreedyPolicy(QPolicy(tss, env.action_spec(), qnet))).save(
      str(export), qnet)
  assert json.load(open(export / "exported_manifest.json"))["platforms"] \
      == ["cpu"]
  for build in (lambda: load_policy(str(export)),
                lambda: make_encoding_network(tss.observation),
                lambda: eval_job_torch.run_eval_job(
                    eval_job_torch.parse_args([f"--root_dir={tmp_path}",
                                               "--max_evals=1"]),
                    make_env=CartPole, log=lambda line: None)):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      build()


def test_every_jax_module_has_a_port_twin():
  """Each module of `agents_tpu` has a counterpart in the port, a `jax_*`
  module counting as `torch_*` and `stablehlo_export` as `torch_export`;
  the bandit packages export the JAX packages' names (a `Jax` in a name
  counting as `Torch`)."""
  import importlib
  jax_root = os.path.join(ROOT, "agents_tpu")
  missing = []
  for d, _, files in os.walk(jax_root):
    for f in files:
      if not f.endswith(".py") or f == "__init__.py":
        continue
      rel = os.path.relpath(os.path.join(d, f), jax_root)
      rel = os.path.join(os.path.dirname(rel), os.path.basename(rel)
                         .replace("jax_", "torch_").replace(
                             "stablehlo_export", "torch_export"))
      if not os.path.exists(os.path.join(ROOT, "agents_tpu_torch", rel)):
        missing.append(rel)
  assert missing == []
  for pkg in ("agents", "environments", "metrics", "multi_objective",
              "policies"):
    jax_names = set()
    for node in ast.walk(ast.parse(open(os.path.join(
        jax_root, "bandits", pkg, "__init__.py")).read())):
      if (isinstance(node, (ast.Assign, ast.AugAssign))
          and isinstance(node.value, ast.List)):
        jax_names |= set(ast.literal_eval(node.value))
    port = importlib.import_module(f"agents_tpu_torch.bandits.{pkg}")
    assert set(port.__all__) == {n.replace("Jax", "Torch")
                                 for n in jax_names}, pkg
    for name in port.__all__:
      assert hasattr(port, name), (pkg, name)


def test_every_jax_example_has_a_port_twin():
  """Each JAX example, ``examples/*.py`` without `_torch`, has a twin in
  the port: ``cql_sac_offline.py``'s host pipeline is
  ``cql_sac_offline_host_torch.py`` (``cql_sac_offline_torch.py`` is the
  twin of ``tests/test_cql_offline_e2e.py``'s device pipeline), every
  other ``x.py`` is ``x_torch.py``. ``bench.py``, at the repository's
  root, is not an example: its twin is ``bench_torch.py`` beside it.
  """
  twins = {"cql_sac_offline.py": "cql_sac_offline_host_torch.py"}
  examples = os.path.join(ROOT, "examples")
  jax_examples = sorted(f for f in os.listdir(examples)
                        if f.endswith(".py") and not f.endswith("_torch.py"))
  assert len(jax_examples) == 10
  missing = [f for f in jax_examples if not os.path.exists(os.path.join(
      examples, twins.get(f, f[:-3] + "_torch.py")))]
  assert missing == []
  assert set(twins.values()) | {f[:-3] + "_torch.py" for f in jax_examples
                                if f not in twins} <= set(EXAMPLES)
  assert os.path.exists(os.path.join(ROOT, "bench_torch.py"))


def test_bandit_entry_points_raise_without_a_card(monkeypatch):
  """The bandit environments, agents, networks and the example's loop
  default to "cuda" and raise without a card; so does
  `RaggedArray.from_rows`."""
  import numpy as np

  from agents_tpu_torch.bandits import agents, environments
  from agents_tpu_torch.bandits.environments import environment_utilities
  from agents_tpu_torch.bandits.networks import \
      global_and_arm_feature_network as gaf
  from agents_tpu_torch.bandits.specs import bandit_spec_utils
  from agents_tpu_torch.specs import array_spec
  from agents_tpu_torch.trajectories import time_step as ts
  from agents_tpu_torch.utils import composite
  from examples import bandits_train_eval_torch as example

  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  tss = ts.time_step_spec(array_spec.ArraySpec((2,), np.float32))
  act = array_spec.BoundedArraySpec((), np.int32, 0, 2)
  spec = bandit_spec_utils.create_per_arm_observation_spec(2, 2, 3)
  for build in (
      lambda: environments.StationaryStochasticBandit(np.eye(2)),
      lambda: environments.BernoulliBandit([0.5, 0.5]),
      lambda: environments.PiecewiseStationaryStochasticBandit(2, 2, 2, [1]),
      lambda: environments.MovieLensPerArmBandit(np.ones((4, 4))),
      lambda: environment_utilities.LinearNormalReward([1.0, 2.0]),
      lambda: agents.LinUcbAgent(tss, act),
      lambda: agents.Exp3Agent(tss, act),
      lambda: gaf.make_global_and_arm_feature_network(spec),
      lambda: example.build_loop(example.Config()),
      lambda: composite.RaggedArray.from_rows([np.zeros(2, np.float32)])):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      build()


# --- The public surface, name by name --------------------------------------
#
# `test_every_jax_public_name_has_a_port_twin` walks every module of
# `agents_tpu` by `ast` and looks each public name up in the port module of
# the same path (imported, so inherited members count):
#   - each name of a package's `__all__`;
#   - each public top-level function and class;
#   - each public method of those classes, `__call__` and properties
#     included;
#   - each parameter of those functions and methods, a class's `__init__`
#     checked against the port class's constructor;
#   - each public annotated field of a class (a dataclass's, NamedTuple's
#     or flax module's constructor argument, or a class attribute), found
#     as a constructor parameter or an attribute of the port class.
# A name the port spells differently is in one of the rename tables; a
# name with no meaning outside JAX, flax, optax or orbax is in EXCLUDED.
# Every entry carries its reason, every rename must resolve to a port name
# that exists, and every entry must match at least one JAX name.

# Renames that hold wherever the JAX name appears: pattern -> (port name,
# reason). A pattern is a regular expression over the whole name.
RENAMED_CLASSES = {
    r"(.*)Jax(.*)": (r"\1Torch\2", "the framework's name in a class name"),
}
RENAMED_METHODS = {
    r"__call__": ("forward",
                  "a torch module's call runs `forward` (flax modules and "
                  "the port's other callables keep `__call__`)"),
}
RENAMED_PARAMS = {
    r"key": ("draws", "a PRNG key becomes a draw source (`utils/draws.py`)"),
    r"(\w*)optimizer": (r"\1optimizer_fn",
                        "an optax transformation becomes a factory of "
                        "torch optimizers over the parameters"),
    r"(\w*)opt_state(s?)": (r"\1optimizer\2",
                            "an optax state becomes the torch optimizer "
                            "that holds it"),
    r"(\w*)_params(\w*)": (r"\1_network\2",
                           "a flax parameter tree becomes the torch module "
                           "that holds it"),
    r"axis": ("dim", "torch names a tensor's axis `dim`"),
    r"(axis_name|data_axis)": ("mesh",
                               "a named mesh axis becomes the port's "
                               "data-parallel group (`parallel/mesh_utils."
                               "py`)"),
}
# Renames at one site: "module:Qualname" or "module:Qualname(param)" ->
# (port name, reason). A name with a ":" resolves in another port module.
RENAMED = {
    "networks.lstm_networks:LSTMEncoderModule": (
        "LSTMEncoder", "a torch module needs no `Module` suffix to tell it "
        "from its flax parameters"),
    "networks.network:variance_scaling": (
        "variance_scaling_", "flax returns an initializer; torch's "
        "initializers fill a tensor in place (trailing underscore)"),
    "replay_buffers.host_ingest:ensure_built": (
        "agents_tpu_torch.utils.native_build:build_library",
        "the port builds every native library through one function"),
    "train.variable_container:ensure_built": (
        "agents_tpu_torch.utils.native_build:build_library",
        "the port builds every native library through one function"),
    "eval.metric_utils:evaluate_jax_env": (
        "evaluate_torch_env", "the framework's name in a function name"),
    "eval.metric_utils:evaluate_jax_env_episodes": (
        "evaluate_torch_env_episodes",
        "the framework's name in a function name"),
    "utils.nest_utils:flatten(nest)": (
        "tree", "the port's nest functions name their argument `tree`"),
    "agents.behavioral_cloning.behavioral_cloning_agent:BcAgentState."
    "params": ("network", "a flax parameter tree becomes the torch "
               "module that holds it"),
    "networks.projection_networks:CategoricalProjection.num_actions": (
        "sample_spec", "the port builds the head from the action spec; "
        "`num_actions` is an attribute of the built module"),
    "networks.projection_networks:CategoricalProjection.event_shape": (
        "sample_spec", "the port builds the head from the action spec; "
        "`event_shape` is an attribute of the built module"),
    "train.fused_loop:FusedTrainLoop.evaluate(key)": (
        "seed_or_draws", "a PRNG key becomes a seed or a draw source"),
    "utils.common:global_norm(tree)": (
        "tensors", "the norm of the tensors of a nest or a list"),
}
# Names with no meaning in PyTorch: pattern over "module:Qualname" or
# "module:Qualname(param)" (`fnmatch`) -> reason.
EXCLUDED = {
    "*:*Agent.init(key)":
        "flax builds parameters from a key in `init`; a torch module "
        "builds its parameters when it is constructed, so these `init`s "
        "take no draws",
    "bandits.policies.constraints:*.init_params(key)":
        "flax builds a constraint network's parameters from a key; the "
        "port's constraint networks build theirs when constructed",
    "agents.*:*.critic_loss(critic_params)":
        "`jax.grad` differentiates a loss in its parameter argument; "
        "torch.autograd differentiates the tensors that the state's "
        "modules hold, so a port loss reads them from `agent_state`",
    "agents.*:*.actor_loss(actor_params)":
        "`jax.grad` differentiates a loss in its parameter argument; "
        "torch.autograd differentiates the tensors that the state's "
        "modules hold, so a port loss reads them from `agent_state`",
    "agents.*:*.actor_and_alpha_loss(*_*)":
        "`jax.grad` differentiates a loss in its parameter arguments "
        "(actor params, log alpha); torch.autograd differentiates the "
        "tensors `agent_state` holds",
    "agents.*:*.critic_loss(key)":
        "a JAX agent folds a key per step; the port's agent state "
        "carries its draw source (`agent_state.draws`)",
    "agents.*:*.actor_and_alpha_loss(key)":
        "a JAX agent folds a key per step; the port's agent state "
        "carries its draw source (`agent_state.draws`)",
    "agents.*:*.train(key)":
        "a JAX agent folds a key per step (or takes one to override "
        "it); the port's agent state carries its draw source",
    "train.fused_loop:FusedTrainLoop.initial_collect(key)":
        "a JAX loop splits its state's key; the port's loop state "
        "carries its draw source (`LoopState.draws`)",
    "train.*:*.iteration(_)":
        "`lax.scan`'s per-step input, which a JAX loop iteration "
        "ignores; the port's loops iterate in Python",
    "bandits.environments.bandit_envs:BanditState.key":
        "a JAX environment state carries its PRNG key; the port's "
        "environments take a draw source at each call",
    "networks.network:Network.__init__(module)":
        "the JAX Network wraps a flax module whose parameters live "
        "outside it; a port Network is the torch module itself",
    "networks.network:Network.init_params":
        "flax's `module.init(key, ...)`; a torch module builds its "
        "parameters when it is constructed",
    "networks.network:Network.apply(*)":
        "flax's functional call with external parameters; a torch "
        "module is called with its own (`net(observation, step_type, "
        "network_state)`; `nn.Module.apply` is torch's, unrelated)",
    "utils.common:aggregate_losses(axis_name)":
        "under `shard_map` a JAX loss divides by the replica count so "
        "that psummed gradients average; the port averages gradients "
        "over the mesh in `agents.agent.apply_gradients`",
    "replay_buffers.uniform_replay:renorm_count":
        "keeps a traced int32 frame count from overflowing under jit; "
        "the port's counts are host ints",
    "policies.policy_saver:PolicySaver.save(stablehlo)":
        "selects the StableHLO artifact beside the orbax checkpoint; "
        "the port always writes its torch.export artifact",
    "train.checkpointer:Checkpointer.manager":
        "orbax's CheckpointManager; the port's Checkpointer writes "
        "its own files (`train/checkpointer.py`)",
}


def _jax_to_port_module(rel: str) -> str:
  parts = rel[:-3].split(os.sep)
  parts[-1] = parts[-1].replace("jax_", "torch_").replace(
      "stablehlo_export", "torch_export")
  return "agents_tpu_torch." + ".".join(parts)


def _params(fn) -> list:
  a = fn.args
  names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
  names += [v.arg for v in (a.vararg, a.kwarg) if v is not None]
  return [n for n in names if n not in ("self", "cls")]


def _signature_params(obj):
  import inspect
  try:
    return set(inspect.signature(obj).parameters)
  except (TypeError, ValueError):
    return set()


def _jax_public_surface():
  """(module, qualname, param or None, kind, port object getter args) of
  every public name of `agents_tpu`, walked by `ast`."""
  jax_root = os.path.join(ROOT, "agents_tpu")
  out = []
  for d, _, files in sorted(os.walk(jax_root)):
    for f in sorted(files):
      if not f.endswith(".py"):
        continue
      rel = os.path.relpath(os.path.join(d, f), jax_root)
      tree = ast.parse(open(os.path.join(d, f)).read())
      if f == "__init__.py":
        pkg = ".".join(["agents_tpu_torch"] + os.path.dirname(rel).split(
            os.sep)).rstrip(".")
        for node in tree.body:
          if (isinstance(node, ast.Assign) and any(
              getattr(t, "id", None) == "__all__" for t in node.targets)):
            out += [(pkg[len("agents_tpu_torch."):], name, None, "function")
                    for name in ast.literal_eval(node.value)]
        continue
      mod = _jax_to_port_module(rel)[len("agents_tpu_torch."):]
      for node in tree.body:
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and not node.name.startswith("_")):
          out.append((mod, node.name, None, "function"))
          out += [(mod, node.name, p, "param") for p in _params(node)]
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
          out.append((mod, node.name, None, "class"))
          for m in node.body:
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
              if m.name == "__init__":
                out += [(mod, f"{node.name}.__init__", p, "param")
                        for p in _params(m)]
              elif not m.name.startswith("_") or m.name == "__call__":
                q = f"{node.name}.{m.name}"
                out.append((mod, q, None, "method"))
                out += [(mod, q, p, "param") for p in _params(m)]
            elif (isinstance(m, ast.AnnAssign)
                  and isinstance(m.target, ast.Name)
                  and not m.target.id.startswith("_")):
              out.append((mod, f"{node.name}.{m.target.id}", None, "field"))
  return out


def _rename(table, name):
  import re
  for pattern, (new, _) in table.items():
    if re.fullmatch(pattern, name):
      return re.sub(pattern, new, name, count=1), pattern
  return name, None


def _has(owner, name) -> bool:
  """Whether a module or a class (its MRO, not its metaclass) defines
  `name`."""
  if isinstance(owner, type):
    return any(name in vars(c) for c in owner.__mro__)
  return hasattr(owner, name)


def _member(owner, name):
  """`owner.name` where `_has` finds it, else None."""
  return getattr(owner, name) if _has(owner, name) else None


def test_every_jax_public_name_has_a_port_twin():
  """Every public function, class, method, parameter and field of
  `agents_tpu` has its twin in the port, under the same name or a rename
  of the tables above, unless EXCLUDED says why it means nothing in
  PyTorch."""
  import fnmatch
  import importlib
  used = set()
  missing = []

  def excluded(site):
    hits = [p for p in EXCLUDED if fnmatch.fnmatchcase(site, p)]
    used.update(hits)
    return bool(hits)

  def site_rename(site, module):
    """(module, port name) of a site-level rename, or None."""
    if site not in RENAMED:
      return None
    used.add(site)
    target = RENAMED[site][0]
    if ":" in target:
      module_name, target = target.split(":")
      module = importlib.import_module(module_name)
    return module, target

  def lookup(owner, name, site, table):
    """The port object for JAX `name` at `site`: a site rename, then a
    table rename, then the name itself; None when absent."""
    renamed = site_rename(site, owner)
    if renamed is not None:
      return _member(*renamed)
    new, pattern = _rename(table, name)
    if pattern is not None and _has(owner, new):
      used.add(pattern)
      return _member(owner, new)
    return _member(owner, name)

  def has_name(names, owner, name, site):
    """Whether `name` (a parameter or field) is in `names` or, for a
    field, an attribute of `owner`, under a rename where there is one."""
    renamed = site_rename(site, owner)
    candidates = [renamed[1]] if renamed else [name]
    new, pattern = _rename(RENAMED_PARAMS, name)
    if renamed is None and pattern is not None:
      candidates.append(new)
    for i, c in enumerate(candidates):
      if c in names or (owner is not None and _has(owner, c)):
        if i == 1:
          used.add(pattern)
        return True
    return False

  for mod, qual, param, kind in _jax_public_surface():
    site = f"{mod}:{qual}" + (f"({param})" if param else "")
    owner_name, _, member = qual.partition(".")
    module = importlib.import_module(f"agents_tpu_torch.{mod}")
    owner = lookup(module, owner_name, f"{mod}:{owner_name}",
                   RENAMED_CLASSES)
    if owner is None:
      found = kind not in ("function", "class")   # reported once, there
    elif kind == "method":
      found = lookup(owner, member, site, RENAMED_METHODS) is not None
    elif kind == "field":
      found = has_name(_signature_params(owner), owner, member, site)
    elif kind == "param":
      fn = owner if member in ("", "__init__") else lookup(
          owner, member, f"{mod}:{qual}", RENAMED_METHODS)
      # A missing method is reported once, as the method.
      found = fn is None or has_name(_signature_params(fn), None, param,
                                     site)
    else:
      found = True
    if not found and not excluded(site):
      missing.append(site)
  assert missing == [], "\n".join(missing)
  tables = [RENAMED_CLASSES, RENAMED_METHODS, RENAMED_PARAMS, RENAMED,
            EXCLUDED]
  stale = [k for table in tables for k in table if k not in used]
  assert stale == [], stale
  reasons = [v[1] if isinstance(v, tuple) else v for table in tables
             for v in table.values()]
  assert all(isinstance(r, str) and len(r) > 20 for r in reasons)
