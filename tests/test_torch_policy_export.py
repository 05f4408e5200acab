"""Policy export and reload: `agents_tpu_torch.policies.{torch_export,
policy_saver,registry}` and `networks.registry` against the JAX package,
and the gamma, beta and permutation draws an artifact transforms itself.

Twins of ``tests/test_stablehlo_export.py`` and
``tests/test_policy_artifact.py``. Each network is built and initialised
on the JAX side and carried across by `utils/convert.py`, so both
packages act with the same params. The port's artifact runs in a fresh
interpreter that imports numpy and torch only (the loader the artifact
carries; neither `agents_tpu`, `agents_tpu_torch` nor JAX may load).
Greedy discrete actions must equal the JAX policy's except on rows whose
top two Q values lie within 1e-5; continuous ones agree to rtol 1e-5 /
atol 1e-6.
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from agents_tpu import networks as jnetworks
from agents_tpu import specs as jspecs
from agents_tpu.policies import registry as jpol_registry
from agents_tpu.policies import stablehlo_export
from agents_tpu.policies.actor_policy import ActorPolicy as JaxActorPolicy
from agents_tpu.policies.q_policy import QPolicy as JaxQPolicy
from agents_tpu.policies.wrappers import EpsilonGreedyPolicy as JaxEpsGreedy
from agents_tpu.policies.wrappers import GreedyPolicy as JaxGreedyPolicy
from agents_tpu.trajectories import time_step as jts
from agents_tpu_torch import networks, specs
from agents_tpu_torch.networks import registry as net_registry
from agents_tpu_torch.policies import (ActorPolicy, CEMPolicy,
                                       EpsilonGreedyPolicy, GaussianPolicy,
                                       GreedyPolicy, QPolicy)
from agents_tpu_torch.policies import policy_saver
from agents_tpu_torch.policies import registry as pol_registry
from agents_tpu_torch.policies import torch_export
from agents_tpu_torch.policies.policy_saver import (PolicySaver,
                                                    load_manifest,
                                                    load_policy)
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import convert
from agents_tpu_torch.utils import draws as draws_lib
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import assert_close

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBS = specs.ArraySpec((4,), np.float32)
TSS = ts.time_step_spec(OBS)
DISC = specs.BoundedArraySpec((), np.int32, 0, 2)
CONT = specs.BoundedArraySpec((2,), np.float32, -1.0, 1.0)
J_OBS = jspecs.ArraySpec((4,), np.float32)
J_TSS = jts.time_step_spec(J_OBS)
J_DISC = jspecs.BoundedArraySpec((), np.int32, 0, 2)
J_CONT = jspecs.BoundedArraySpec((2,), np.float32, -1.0, 1.0)


def _jax_q(fc, seed):
  net = jnetworks.make_q_network(J_OBS, J_DISC, fc_layer_params=fc)
  return net, net.init_params(jax.random.key(seed))


def _port_q(params, fc):
  net = networks.make_q_network(OBS, DISC, fc_layer_params=fc, device="cpu")
  net.load_state_dict(convert.q_params_to_state_dict(params))
  return net


def _jax_sac_actor(fc, seed):
  net = jnetworks.make_sac_actor_network(J_OBS, J_CONT, fc_layer_params=fc)
  return net, net.init_params(jax.random.key(seed))


def _port_sac_actor(params, fc):
  net = networks.make_sac_actor_network(OBS, CONT, fc_layer_params=fc,
                                        device="cpu")
  net.load_state_dict(convert.sac_actor_params_to_state_dict(params))
  return net


def _jax_step(obs, step_type=1):
  b = obs.shape[0]
  return jts.TimeStep(step_type=np.full((b,), step_type, np.int32),
                      reward=np.zeros((b,), np.float32),
                      discount=np.ones((b,), np.float32), observation=obs)


def _port_step(obs, step_type=1):
  b = obs.shape[0]
  return ts.TimeStep(step_type=torch.full((b,), step_type, dtype=torch.int32),
                     reward=torch.zeros(b), discount=torch.ones(b),
                     observation=torch.as_tensor(obs))


def _jax_action(policy, params, obs, state=()):
  step = policy.action(params, _jax_step(obs), state, jax.random.key(0))
  return np.asarray(step.action), step.state


def _assert_greedy_equal(got, expected, q):
  """Equal on every row whose top two Q values are more than 1e-5 apart."""
  top2 = np.sort(np.asarray(q), axis=-1)[:, -2:]
  clear = (top2[:, 1] - top2[:, 0]) > 1e-5
  np.testing.assert_array_equal(np.asarray(got)[clear],
                                np.asarray(expected)[clear])
  assert clear.mean() > 0.5


def _run_bare_child(artifact_dir, obs, tmp_path, extra=""):
  """The artifact's own loader.py in a fresh interpreter, from a neutral
  cwd and without PYTHONPATH; neither agents_tpu, agents_tpu_torch nor jax
  may load. Returns the action leaves."""
  obs_path = os.path.join(str(tmp_path), "obs.npy")
  np.save(obs_path, obs)
  child = textwrap.dedent(f"""
      import importlib.util, json, sys
      import numpy as np
      spec = importlib.util.spec_from_file_location(
          "artifact_loader", {repr(os.path.join(artifact_dir, "loader.py"))})
      loader = importlib.util.module_from_spec(spec)
      spec.loader.exec_module(loader)
      policy = loader.ExportedPolicy({repr(artifact_dir)}, platform="cpu")
      obs = np.load({repr(obs_path)})
      acts, state = policy.action([obs])
      {extra}
      leaked = [m for m in sys.modules
                if m.split(".")[0] in ("agents_tpu", "agents_tpu_torch",
                                       "jax", "jaxlib", "flax")]
      assert not leaked, leaked
      print("CHILD_OK", json.dumps([a.tolist() for a in acts]))
  """)
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                       text=True, timeout=300, env=env, cwd=str(tmp_path))
  assert "CHILD_OK" in out.stdout, (out.stdout[-1000:], out.stderr[-2000:])
  payload = out.stdout.split("CHILD_OK", 1)[1].strip()
  return [np.asarray(a) for a in json.loads(payload)]


def _loader(artifact_dir):
  spec = importlib.util.spec_from_file_location(
      f"loader_{abs(hash(artifact_dir))}",
      os.path.join(artifact_dir, "loader.py"))
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.ExportedPolicy(artifact_dir, platform="cpu")


# -- twins of tests/test_stablehlo_export.py -------------------------------

def test_greedy_q_policy_acts_without_framework(tmp_path):
  jnet, params = _jax_q((16,), 1)
  net = _port_q(params, (16,))
  policy = GreedyPolicy(QPolicy(TSS, DISC, net))
  export = str(tmp_path / "export")
  PolicySaver(policy, train_step=3).save(export, net)
  assert os.path.exists(os.path.join(export, "exported_action_cpu.pt2"))
  manifest = json.load(open(os.path.join(export, "exported_manifest.json")))
  assert manifest["batch"] == "polymorphic"
  assert manifest["draw_sites"] == [] and manifest["platforms"][0] == "cpu"

  obs = np.random.RandomState(0).randn(5, 4).astype(np.float32)
  expected, _ = _jax_action(JaxGreedyPolicy(JaxQPolicy(J_TSS, J_DISC, jnet)),
                            params, obs)
  (got,) = _run_bare_child(export, obs, tmp_path)
  q = jnet.apply(params, obs)[0]
  _assert_greedy_equal(got, expected, q)


def test_sac_actor_greedy_continuous(tmp_path):
  jnet, params = _jax_sac_actor((16, 16), 2)
  net = _port_sac_actor(params, (16, 16))
  export = str(tmp_path / "export_sac")
  PolicySaver(GreedyPolicy(ActorPolicy(TSS, CONT, net))).save(export, net)
  jpolicy = JaxGreedyPolicy(JaxActorPolicy(J_TSS, J_CONT, jnet))
  rng = np.random.RandomState(1)
  for b in (2, 7):   # the export is batch-polymorphic
    obs = rng.randn(b, 4).astype(np.float32)
    expected, _ = _jax_action(jpolicy, params, obs)
    (got,) = _run_bare_child(export, obs, tmp_path)
    assert got.shape == (b, 2)
    assert_close(got, expected)


def test_params_refresh_without_reexport(tmp_path):
  """save_checkpoint rewrites the params only; the bare loader acts with
  the new weights."""
  jnet, p1 = _jax_q((8,), 1)
  _, p2 = _jax_q((8,), 9)
  net1, net2 = _port_q(p1, (8,)), _port_q(p2, (8,))
  saver = PolicySaver(GreedyPolicy(QPolicy(TSS, DISC, net1)))
  export = str(tmp_path / "export_refresh")
  saver.save(export, net1)
  program = os.path.join(export, "exported_action_cpu.pt2")
  mtime = os.stat(program).st_mtime_ns
  saver.save_checkpoint(export, net2)
  assert os.stat(program).st_mtime_ns == mtime

  obs = np.random.RandomState(2).randn(6, 4).astype(np.float32)
  expected, _ = _jax_action(JaxGreedyPolicy(JaxQPolicy(J_TSS, J_DISC, jnet)),
                            p2, obs)
  (got,) = _run_bare_child(export, obs, tmp_path)
  _assert_greedy_equal(got, expected, jnet.apply(p2, obs)[0])


def test_recurrent_q_policy_state_threading(tmp_path):
  """The LSTM carry goes through the program's flat_state; the two-step
  action sequence matches the JAX policy's."""
  jnet = jnetworks.make_q_rnn_network(J_OBS, J_DISC,
                                      input_fc_layer_params=(8,),
                                      lstm_size=8)
  params = jnet.init_params(jax.random.key(4))
  net = networks.make_q_rnn_network(OBS, DISC, input_fc_layer_params=(8,),
                                    lstm_size=8, device="cpu")
  net.load_state_dict(convert.q_rnn_params_to_state_dict(params, 1))
  export = str(tmp_path / "export_rnn")
  PolicySaver(GreedyPolicy(QPolicy(TSS, DISC, net))).save(export, net)
  manifest = json.load(open(os.path.join(export, "exported_manifest.json")))
  assert manifest["state_leaves"], "LSTM state missing from the manifest"

  rng = np.random.RandomState(4)
  obs1, obs2 = (rng.randn(3, 4).astype(np.float32) for _ in range(2))
  obs2_path = os.path.join(str(tmp_path), "obs2.npy")
  np.save(obs2_path, obs2)
  jpolicy = JaxGreedyPolicy(JaxQPolicy(J_TSS, J_DISC, jnet))
  a1, s1 = _jax_action(jpolicy, params, obs1, jpolicy.init_state(3))
  a2, _ = _jax_action(jpolicy, params, obs2, s1)
  extra = (f"obs2 = np.load({obs2_path!r})\n"
           "      acts2, state2 = policy.action([obs2], state=state)\n"
           "      assert any(np.abs(a).sum() > 0 for a in state)\n"
           "      acts = [np.stack([acts[0], acts2[0]])]")
  (got,) = _run_bare_child(export, obs1, tmp_path, extra=extra)
  np.testing.assert_array_equal(got, np.stack([a1, a2]))


def test_stochastic_policy_exports_and_samples(tmp_path):
  """A stochastic (collect) policy exports too: its draws are program
  inputs that the loader fills from key_data; two keys give different
  actions, within the bounded spec."""
  _, params = _jax_sac_actor((8,), 3)
  net = _port_sac_actor(params, (8,))
  export = str(tmp_path / "export_stoch")
  PolicySaver(ActorPolicy(TSS, CONT, net)).save(
      export, net)
  sites = load_manifest(export)
  assert json.load(open(os.path.join(export, "exported_manifest.json")))[
      "draw_sites"][0]["site"] == "actor_noise"
  assert sites["torch_export"] == "batch-polymorphic"
  obs = np.random.RandomState(3).randn(4, 4).astype(np.float32)
  extra = ("acts2, _ = policy.action([obs], key_data=np.asarray("
           "[7, 9], np.uint32))\n"
           "      assert not np.allclose(acts[0], acts2[0])\n"
           "      assert np.all(np.abs(acts2[0]) <= 1.0 + 1e-6)")
  (got,) = _run_bare_child(export, obs, tmp_path, extra=extra)
  assert got.shape == (4, 2) and np.all(np.abs(got) <= 1.0 + 1e-6)


def _stochastic_cases():
  """(name, policy, params) of exportable policies that draw."""
  _, sac = _jax_sac_actor((8,), 5)
  actor = _port_sac_actor(sac, (8,))
  _, qp = _jax_q((8,), 6)
  q = _port_q(qp, (8,))
  critic = networks.make_critic_network(OBS, CONT, joint_fc_layer_params=(8,),
                                        device="cpu")
  return [
      ("actor", ActorPolicy(TSS, CONT, actor), actor),
      ("gaussian", GaussianPolicy(GreedyPolicy(ActorPolicy(TSS, CONT, actor)),
                                  scale=0.3), actor),
      ("epsilon_greedy", EpsilonGreedyPolicy(QPolicy(TSS, DISC, q), 0.5), q),
      ("raw_q", QPolicy(TSS, DISC, q), q),
      ("cem", CEMPolicy(TSS, CONT, critic, num_samples=8, num_elites=2,
                        num_iterations=2), critic),
  ]


@pytest.mark.parametrize("case", range(5),
                         ids=["actor", "gaussian", "epsilon_greedy", "raw_q",
                              "cem"])
def test_artifact_draws_replay_into_the_eager_policy(tmp_path, case):
  """The loader's draws for a key, replayed at their sites into the eager
  policy, give the artifact's actions: the program consumes its draw
  inputs exactly where the policy draws."""
  name, policy, params = _stochastic_cases()[case]
  export = str(tmp_path / name)
  manifest = torch_export.export_action(policy, params, export)
  assert manifest["draw_sites"]
  loaded = _loader(export)
  obs = np.random.RandomState(case).randn(6, 4).astype(np.float32)
  key = np.asarray([3, case], np.uint32)
  got, _ = loaded.action([obs], key_data=key)
  records = {}
  for d, x in zip(manifest["draw_sites"], loaded.draw_inputs(6, key)):
    records.setdefault(d["site"], []).append(x)
  with torch.no_grad():
    eager = policy.action(params, _port_step(obs), (), ReplayDraws(records))
  np.testing.assert_allclose(got[0], eager.action.numpy(), rtol=1e-6,
                             atol=1e-6)


def test_port_artifact_acts_as_the_jax_artifact(tmp_path):
  """The same params exported by both packages: the JAX StableHLO
  artifact and the port's torch.export artifact give the same greedy
  actions (Q policy, tie rule) and continuous actions (SAC actor)."""
  rng = np.random.RandomState(8)
  jq, qparams = _jax_q((32, 16), 11)
  q = _port_q(qparams, (32, 16))
  ja, aparams = _jax_sac_actor((16,), 12)
  actor = _port_sac_actor(aparams, (16,))
  cases = (
      (JaxGreedyPolicy(JaxQPolicy(J_TSS, J_DISC, jq)), qparams,
       GreedyPolicy(QPolicy(TSS, DISC, q)), q, "q"),
      (JaxGreedyPolicy(JaxActorPolicy(J_TSS, J_CONT, ja)), aparams,
       GreedyPolicy(ActorPolicy(TSS, CONT, actor)), actor, "actor"))
  for jpolicy, jparams, policy, params, name in cases:
    jdir, tdir = str(tmp_path / f"jax_{name}"), str(tmp_path / name)
    stablehlo_export.export_action(jpolicy, jparams, jdir,
                                   platforms=("cpu",))
    torch_export.export_action(policy, params, tdir)
    jspec = importlib.util.spec_from_file_location(
        f"jax_loader_{name}", os.path.join(jdir, "loader.py"))
    jloader = importlib.util.module_from_spec(jspec)
    jspec.loader.exec_module(jloader)
    jexported, texported = jloader.ExportedPolicy(jdir), _loader(tdir)
    for b in (1, 9):
      obs = rng.randn(b, 4).astype(np.float32)
      (want,), _ = jexported.action([obs])
      (got,), _ = texported.action([obs])
      if name == "q":
        _assert_greedy_equal(got, want, jq.apply(qparams, obs)[0])
      else:
        assert_close(got, want)


# -- twins of tests/test_policy_artifact.py --------------------------------

def test_policy_config_roundtrip_q_and_wrappers():
  jnet, params = _jax_q((16,), 0)
  net = _port_q(params, (16,))
  pol = EpsilonGreedyPolicy(QPolicy(TSS, DISC, net), epsilon=0.25)
  cfg = pol_registry.policy_config(pol)
  assert cfg["type"] == "EpsilonGreedyPolicy"
  assert cfg["kwargs"]["epsilon"] == 0.25
  jcfg = jpol_registry.policy_config(
      JaxEpsGreedy(JaxQPolicy(J_TSS, J_DISC, jnet), epsilon=0.25))
  # The same JSON config as the JAX package's.
  assert json.loads(json.dumps(cfg)) == json.loads(json.dumps(jcfg))
  cfg = json.loads(json.dumps(cfg))
  rebuilt = pol_registry.build_policy(cfg, TSS, DISC, device="cpu")
  assert isinstance(rebuilt, EpsilonGreedyPolicy)
  assert type(rebuilt.wrapped) is QPolicy
  assert rebuilt.epsilon == 0.25


def test_policy_config_opaque_cases():
  from agents_tpu_torch.networks.q_network import QModule
  from agents_tpu_torch.utils.tensor_normalizer import \
      EMATensorNormalizer
  net = networks.make_q_network(OBS, DISC, device="cpu")
  # A callable epsilon (or temperature) is unrepresentable.
  assert pol_registry.policy_config(EpsilonGreedyPolicy(
      QPolicy(TSS, DISC, net), epsilon=lambda p: 0.1)) is None
  # A splitter is a callable too.
  assert pol_registry.policy_config(QPolicy(
      TSS, DISC, net,
      observation_and_action_constraint_splitter=lambda o: (o, None))) is None
  # A hand-assembled network (no factory, no build_config).
  raw = QModule(OBS, 3, fc_layer_params=(8,), device="cpu")
  assert pol_registry.policy_config(QPolicy(TSS, DISC, raw)) is None
  # An observation normalizer.
  actor = networks.make_sac_actor_network(OBS, CONT, (8,), device="cpu")
  assert pol_registry.policy_config(ActorPolicy(
      TSS, CONT, actor,
      observation_normalizer=EMATensorNormalizer(OBS))) is None
  # A CEM sampler with clippers.
  from agents_tpu_torch.policies.cem_samplers import \
      GaussianContinuousSampler
  critic = networks.make_critic_network(OBS, CONT, device="cpu")
  sampler = GaussianContinuousSampler(CONT, sample_clippers=(lambda a: a,))
  assert pol_registry.policy_config(
      CEMPolicy(TSS, CONT, critic, sampler=sampler)) is None
  assert pol_registry.policy_config(CEMPolicy(TSS, CONT, critic)) is not None
  # A network built with an unrepresentable argument records no config.
  prep = networks.make_q_network(OBS, DISC, preprocessing=lambda x: x,
                                 device="cpu")
  assert prep.build_config is None


FACTORIES = {
    "make_q_network": (lambda m, o, a: m.make_q_network(
        o, a, fc_layer_params=(8, 4), dueling=True)),
    "make_categorical_q_network": (lambda m, o, a: m.make_categorical_q_network(
        o, a, num_atoms=5, fc_layer_params=(8,))),
    "make_encoding_network": (lambda m, o, a: m.make_encoding_network(
        o, fc_layer_params=(6,))),
    "make_value_network": (lambda m, o, a: m.make_value_network(
        o, fc_layer_params=(8,))),
    "make_critic_network": (lambda m, o, a: m.make_critic_network(
        o, a, joint_fc_layer_params=(8,))),
    "make_actor_distribution_network": (
        lambda m, o, a: m.make_actor_distribution_network(
            o, a, fc_layer_params=(8,))),
    "make_sac_actor_network": (lambda m, o, a: m.make_sac_actor_network(
        o, a, fc_layer_params=(8,))),
    "make_deterministic_actor_network": (
        lambda m, o, a: m.make_deterministic_actor_network(
            o, a, fc_layer_params=(8,))),
    "make_q_rnn_network": (lambda m, o, a: m.make_q_rnn_network(
        o, a, input_fc_layer_params=(4,), lstm_size=4)),
    "make_value_rnn_network": (lambda m, o, a: m.make_value_rnn_network(
        o, input_fc_layer_params=(4,), lstm_size=4)),
    "make_actor_distribution_rnn_network": (
        lambda m, o, a: m.make_actor_distribution_rnn_network(
            o, a, input_fc_layer_params=(4,), lstm_size=4)),
}
CONTINUOUS = ("make_critic_network", "make_sac_actor_network",
              "make_deterministic_actor_network")


class _Cpu:
  """The port's `networks` with every factory called on the CPU."""

  def __getattr__(self, name):
    fn = getattr(networks, name, None) or net_registry.FACTORY_REGISTRY[name]
    return lambda *a, **k: fn(*a, device="cpu", **k)


@pytest.mark.parametrize("factory", sorted(FACTORIES))
def test_network_build_config_matches_jax_and_rebuilds(factory):
  """Each of the 11 registered factories records the JAX package's
  build_config (JSON) and rebuilds, from it alone, a network of the same
  parameter shapes on the device it is given."""
  from agents_tpu.networks import registry as jnet_registry
  assert factory in net_registry.FACTORY_REGISTRY
  assert factory in jnet_registry.FACTORY_REGISTRY
  cont = factory in CONTINUOUS
  o, a = OBS, (CONT if cont else DISC)
  jo, ja = J_OBS, (J_CONT if cont else J_DISC)
  net = FACTORIES[factory](_Cpu(), o, a)
  jnet = FACTORIES[factory](jnetworks if hasattr(jnetworks, factory)
                            else _JaxRegistry(), jo, ja)
  cfg = json.loads(json.dumps(net.build_config))
  assert cfg == json.loads(json.dumps(jnet.build_config))
  rebuilt = net_registry.build_network(cfg, o, a, device="cpu")
  assert type(rebuilt) is type(net)
  assert {k: v.shape for k, v in rebuilt.state_dict().items()} == {
      k: v.shape for k, v in net.state_dict().items()}


class _JaxRegistry:

  def __getattr__(self, name):
    from agents_tpu.networks import registry as jnet_registry
    return jnet_registry.FACTORY_REGISTRY[name]


def test_self_contained_save_load_same_process(tmp_path):
  jnet, params = _jax_sac_actor((16,), 0)
  net = _port_sac_actor(params, (16,))
  policy = GreedyPolicy(ActorPolicy(TSS, CONT, net))
  PolicySaver(policy, train_step=7, metadata={"env": "test"}).save(
      str(tmp_path / "export"), net)

  loaded = load_policy(str(tmp_path / "export"), device="cpu")
  assert loaded.get_train_step() == 7
  assert loaded.get_metadata() == {"env": "test"}
  obs = np.ones((3, 4), np.float32)
  a = loaded.action(_jax_step(obs, 0)).action
  assert a.shape == (3, 2) and np.all(np.abs(a) <= 1.0)
  expected, _ = _jax_action(JaxGreedyPolicy(JaxActorPolicy(J_TSS, J_CONT,
                                                           jnet)), params, obs)
  assert_close(a, expected)


def test_opaque_artifact_requires_explicit_policy(tmp_path):
  from agents_tpu_torch.networks.q_network import QModule
  net = QModule(OBS, 3, fc_layer_params=(8,), device="cpu")  # no config
  policy = QPolicy(TSS, DISC, net)
  PolicySaver(policy).save(str(tmp_path / "export"), net)
  assert load_manifest(str(tmp_path / "export"))["policy_config"] is None
  with pytest.raises(ValueError, match="policy_config"):
    load_policy(str(tmp_path / "export"), device="cpu")
  template = QModule(OBS, 3, fc_layer_params=(8,), device="cpu")
  loaded = load_policy(str(tmp_path / "export"), policy=policy,
                       params_template=template, device="cpu")
  for k, v in template.state_dict().items():
    assert torch.equal(v, net.state_dict()[k])
  loaded.action(_jax_step(np.ones((3, 4), np.float32), 0))


def test_cross_process_restore(tmp_path):
  """Save here; restore and act in a fresh process given only the export
  directory, through the port's `load_policy`."""
  jnet, params = _jax_q((16,), 1)
  net = _port_q(params, (16,))
  export = str(tmp_path / "export")
  PolicySaver(GreedyPolicy(QPolicy(TSS, DISC, net)), train_step=3).save(
      export, net)
  child = textwrap.dedent(f"""
      import sys; sys.path.insert(0, {ROOT!r})
      import numpy as np
      from agents_tpu_torch.policies.policy_saver import load_policy
      from agents_tpu_torch.trajectories import time_step as ts
      loaded = load_policy({export!r}, device="cpu")
      step = loaded.action(ts.TimeStep(
          step_type=np.zeros((2,), np.int32),
          reward=np.zeros((2,), np.float32),
          discount=np.ones((2,), np.float32),
          observation=np.ones((2, 4), np.float32)))
      assert step.action.shape == (2,) and loaded.get_train_step() == 3
      assert not any(m.split(".")[0] in ("jax", "agents_tpu")
                     for m in sys.modules)
      print("CHILD_OK", step.action.tolist())
  """)
  out = subprocess.run([sys.executable, "-c", child], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path))
  assert "CHILD_OK" in out.stdout, out.stderr[-2000:]
  got = json.loads(out.stdout.split("CHILD_OK", 1)[1])
  expected, _ = _jax_action(JaxGreedyPolicy(JaxQPolicy(J_TSS, J_DISC, jnet)),
                            params, np.ones((2, 4), np.float32))
  assert got == expected.tolist()


def test_trigger_exports_policy_trio(tmp_path):
  from agents_tpu_torch.agents.dqn import DqnAgent
  from agents_tpu_torch.train.triggers import PolicyCheckpointTrigger

  net = networks.make_q_network(OBS, DISC, fc_layer_params=(8,),
                                device="cpu")
  agent = DqnAgent(TSS, DISC, net, torch.optim.Adam, device="cpu")
  state = agent.init()
  trig = PolicyCheckpointTrigger(str(tmp_path), agent, lambda: state,
                                 interval=1)
  trig(1)
  for name in ("greedy_policy", "collect_policy", "policy"):
    d = tmp_path / "policies" / name
    assert (d / "policy_manifest.json").exists(), name
    assert (d / "exported_action_cpu.pt2").exists(), name
  # The collect policy's epsilon schedule is a callable: no config, but
  # an artifact all the same.
  assert load_manifest(str(tmp_path / "policies" / "collect_policy"))[
      "policy_config"] is None
  program = tmp_path / "policies" / "greedy_policy" / "exported_action_cpu.pt2"
  mtime = os.stat(program).st_mtime_ns
  trig(2)   # a params-only refresh
  assert os.stat(program).st_mtime_ns == mtime


def test_publish_saves_whole_then_refreshes_params(tmp_path):
  """A saver's first publish to a directory writes the whole artifact and
  later ones the params and train step only; a new saver (a restarted
  job) writes the whole artifact again."""
  net = networks.make_q_network(OBS, DISC, fc_layer_params=(8,),
                                device="cpu")
  policy = GreedyPolicy(QPolicy(TSS, DISC, net))
  export = str(tmp_path / "published")
  program = os.path.join(export, "exported_action_cpu.pt2")
  saver = PolicySaver(policy)
  saver.publish(export, net, 1)
  first = os.stat(program)
  with torch.no_grad():
    for p in net.parameters():
      p.add_(1.0)
  saver.publish(export, net, 2)
  again = os.stat(program)
  assert (again.st_ino, again.st_mtime_ns) == (first.st_ino,
                                               first.st_mtime_ns)
  assert load_manifest(export)["train_step"] == 2
  saved = torch.load(os.path.join(export, policy_saver.PARAMS_FILE),
                     weights_only=True)
  assert all(torch.equal(saved[path], t)
             for path, t in torch_export.param_leaves(net))
  PolicySaver(policy).publish(export, net, 3)
  assert os.stat(program).st_ino != first.st_ino
  assert load_manifest(export)["train_step"] == 3


def test_failed_card_export_raises_instead_of_saving_cpu_only(tmp_path,
                                                              monkeypatch):
  """A policy that exports on the CPU but not on the card is an error,
  not a CPU-only artifact."""
  net = networks.make_q_network(OBS, DISC, fc_layer_params=(8,),
                                device="cpu")
  real = torch_export._export_one

  def no_card(policy, params, sites, device, batch_size):
    if device.type == "cuda":
      raise RuntimeError("no card here")
    return real(policy, params, sites, device, batch_size)

  monkeypatch.setattr(torch_export, "_export_one", no_card)
  monkeypatch.setattr(policy_saver, "default_platforms",
                      lambda: ("cpu", "cuda"))
  with pytest.raises(torch_export.PlatformExportError,
                     match="exports on the CPU but not"):
    PolicySaver(GreedyPolicy(QPolicy(TSS, DISC, net))).save(
        str(tmp_path / "e"), net)
  assert not (tmp_path / "e" / "exported_action_cpu.pt2").exists()


# -- gamma, beta and permutation draws ----------------------------------------
#
# An artifact takes pre-drawn inputs for these sites and transforms them
# in the program (`utils.draws.marsaglia_tsang_gamma`, `beta_from_inputs`,
# `permutation_from_keys`). The transforms are held against
# `scipy.stats` on numpy draws at a fixed seed (KS, or a chi-square test
# for the permutation, p > 1e-3), and Bernoulli Thompson sampling's policy
# against its own live run over the loader's inputs.

def _gamma_inputs(rng, shape, rounds=draws_lib.GAMMA_ROUNDS):
  return np.concatenate([rng.standard_normal((rounds,) + shape),
                         rng.random((rounds + 1,) + shape)]).astype(
                             np.float32)


@pytest.mark.parametrize("alpha", [0.1, 0.5, 1.0, 5.0, 50.0])
def test_gamma_transform_passes_ks_against_scipy(alpha):
  """alpha < 1 goes through the boost branch, which Bernoulli Thompson
  sampling's alpha >= 1 never reaches."""
  import scipy.stats
  n = 100_000
  rng = np.random.default_rng(int(alpha * 10))
  g = draws_lib.marsaglia_tsang_gamma(torch.full((n,), alpha),
                                      torch.from_numpy(_gamma_inputs(
                                          rng, (n,))))
  assert g.shape == (n,) and torch.isfinite(g).all() and (g >= 0).all()
  assert scipy.stats.kstest(g.numpy(), scipy.stats.gamma(alpha).cdf
                            ).pvalue > 1e-3


def test_gamma_rounds_bound_the_fallback():
  """Round 0 accepts at least 0.951 of proposals at alpha = 1 (the least
  efficient alpha), so all 10 rounds reject with probability below 1e-12;
  the inputs' layout is [2R + 1, *shape]."""
  rng = np.random.default_rng(0)
  x, u = rng.standard_normal(10 ** 6), rng.random(10 ** 6)
  d = 1.0 - 1.0 / 3.0
  v = (1.0 + x / np.sqrt(9.0 * d)) ** 3
  safe = np.where(v > 0, v, 1.0)
  accept = (v > 0) & (np.log(u) < 0.5 * x * x + d - d * safe
                      + d * np.log(safe))
  assert accept.mean() > 0.951
  assert (1.0 - 0.951) ** draws_lib.GAMMA_ROUNDS < 1e-12
  assert draws_lib.gamma_input_shape((4, 3)) == (21, 4, 3)
  # No round accepts: the last proposal, clamped positive.
  inputs = torch.zeros((21, 2))
  inputs[:10] = -10.0                     # v <= 0 in every round
  inputs[10:20] = 0.5
  g = draws_lib.marsaglia_tsang_gamma(torch.tensor([2.0, 3.0]), inputs)
  assert (g > 0).all() and torch.isfinite(g).all()


@pytest.mark.parametrize("a,b", [(1.0, 1.0), (3.0, 7.0), (0.5, 2.0)])
def test_beta_transform_passes_ks_against_scipy(a, b):
  import scipy.stats
  n = 100_000
  rng = np.random.default_rng(int(a * 10 + b))
  inputs = np.stack([_gamma_inputs(rng, (n,)), _gamma_inputs(rng, (n,))])
  x = draws_lib.beta_from_inputs(torch.full((n,), a), torch.full((n,), b),
                                 torch.from_numpy(inputs))
  assert scipy.stats.kstest(x.numpy(), scipy.stats.beta(a, b).cdf
                            ).pvalue > 1e-3


def test_permutation_transform_is_uniform():
  """Each permutation is one; the position of each item over 20,000
  permutations of 8 is uniform (chi-square against scipy)."""
  import scipy.stats
  rng = np.random.default_rng(1)
  counts = np.zeros((8, 8))
  for keys in rng.random((20_000, 8)):
    perm = draws_lib.permutation_from_keys(torch.from_numpy(keys)).numpy()
    assert sorted(perm) == list(range(8))
    counts[perm, np.arange(8)] += 1
  for row in counts:
    assert scipy.stats.chisquare(row).pvalue > 1e-3


def _bernoulli_ts(device="cpu"):
  from agents_tpu_torch.bandits.agents import BernoulliThompsonSamplingAgent
  from agents_tpu_torch.bandits.environments import BernoulliBandit
  env = BernoulliBandit([0.3, 0.5, 0.7, 0.65], device=device)
  agent = BernoulliThompsonSamplingAgent(
      ts.time_step_spec(env.observation_spec()), env.action_spec(),
      device=device)
  state = agent.init()
  state = type(state)(alpha=torch.tensor([3.0, 5.0, 9.0, 2.0]),
                      beta=torch.tensor([4.0, 2.0, 1.0, 7.0]),
                      train_step=12)
  return env, agent, state


def test_bernoulli_thompson_sampling_exports_and_acts_as_live(tmp_path):
  """The Beta posterior draws export as a "beta" site; the artifact, run
  in a bare interpreter, acts as the live policy drawing through
  `InputDraws` over the loader's inputs for the same key; `load_policy`
  restores the posterior."""
  env, agent, state = _bernoulli_ts()
  export = str(tmp_path / "bts")
  PolicySaver(agent.policy, train_step=12).save(export, state)
  assert load_manifest(export)["torch_export"] == "batch-polymorphic"
  manifest = json.load(open(os.path.join(export, "exported_manifest.json")))
  assert manifest["draw_sites"] == [{
      "kind": "beta", "site": "bernoulli_ts_theta", "shape": [None, 4],
      "dtype": "float32", "low": None, "high": None,
      "rounds": draws_lib.GAMMA_ROUNDS}]
  assert manifest["params_leaf_paths"] == ["alpha", "beta"]

  batch = 256
  obs = np.zeros((batch,) + env.observation_spec().shape,
                 env.observation_spec().dtype)
  (got,) = _run_bare_child(export, obs, tmp_path)
  inputs = _loader(export).draw_inputs(batch, np.zeros((2,), np.uint32))
  with torch.no_grad():
    live = agent.policy.action(
        state, _port_step(obs), (), draws_lib.InputDraws(
            manifest["draw_sites"], [torch.from_numpy(x) for x in inputs],
            "cpu")).action
  assert int((got != live.numpy()).sum()) == 0
  assert np.bincount(got, minlength=4).argmax() == 2

  template = agent.init()
  saved = load_policy(export, policy=agent.policy, params_template=template,
                      device="cpu")
  assert torch.equal(saved.params.alpha, state.alpha)
  assert torch.equal(saved.params.beta, state.beta)


def _beta_and_permutation_policy():
  """A policy over a Beta distribution of two learned concentrations per
  action dim (its sample draws two gamma sites) whose action also takes
  the batch's rows in a random order (a permutation site)."""
  from agents_tpu_torch import distributions as tdist
  from agents_tpu_torch.policies.policy import Policy
  from agents_tpu_torch.trajectories import policy_step

  class BetaPolicy(Policy):

    def _distribution(self, params, time_step, state):
      c = torch.nn.functional.softplus(params(time_step.observation)) + 0.2
      return policy_step.PolicyStep(
          action=tdist.Beta(c[..., :2], c[..., 2:]), state=state, info=())

    def _action(self, params, time_step, state, draws):
      dstep = self._distribution(params, time_step, state)
      x = dstep.action.sample(draws, site="beta_gamma")
      order = draws.permutation("rows", x.shape[0])
      return policy_step.PolicyStep(action=x[order], state=state, info=())

  act = specs.BoundedArraySpec((2,), np.float32, 0.0, 1.0)
  net = torch.nn.Linear(4, 4)
  return BetaPolicy(TSS, act, clip=False), net


def test_gamma_and_permutation_sites_export(tmp_path):
  """Gamma and permutation sites (a batch-sized permutation, so its dim is
  the batch's) export, and the artifact acts as the eager policy over the
  same inputs, at two batch sizes."""
  policy, net = _beta_and_permutation_policy()
  export = str(tmp_path / "beta")
  manifest = torch_export.export_action(policy, net, export)
  assert [(s["kind"], s["site"], s["shape"]) for s in
          manifest["draw_sites"]] == [("gamma", "beta_gamma", [None, 2]),
                                      ("gamma", "beta_gamma", [None, 2]),
                                      ("permutation", "rows", [None])]
  assert manifest["draw_sites"][2]["dtype"] == "float64"
  loaded = _loader(export)
  for batch in (5, 9):
    obs = np.random.RandomState(batch).randn(batch, 4).astype(np.float32)
    key = np.asarray([batch, 1], np.uint32)
    got, _ = loaded.action([obs], key_data=key)
    inputs = [torch.from_numpy(x) for x in loaded.draw_inputs(batch, key)]
    with torch.no_grad():
      eager = policy.action(net, _port_step(obs), (), draws_lib.InputDraws(
          manifest["draw_sites"], inputs, "cpu")).action
    np.testing.assert_allclose(got[0], eager.numpy(), rtol=1e-6, atol=1e-6)
    assert got[0].shape == (batch, 2) and np.all((got[0] >= 0)
                                                  & (got[0] <= 1))
