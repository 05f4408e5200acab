"""`examples/dqn_atari_torch.py` (the twin of ``examples/dqn_atari.py``)
and the observation layout of `suites.load_atari` on the CPU.

ALE is not installed here, so gymnasium's `AtariPreprocessing` is replaced
by a stand-in that emits the frames it would ([84, 84] or, with
`grayscale_newaxis`, [84, 84, 1] uint8); both packages' `load_atari`
stack them with their `HistoryWrapper`. The JAX package leaves
`grayscale_newaxis` at its default, so its observation is [84, 336], which
its conv stack takes as one unbatched image (a reference fault the port
does not copy: the port's observation is [84, 84, 4]).

The example's agent is held against a JAX `DqnAgent` built with
``dqn_atari.py:83-92``'s arguments at a narrow conv width, from the JAX
side's params carried across by `convert`: Q values and train steps
(Huber loss, Adam 2.5e-4 with eps 0.01) agree to the conv tolerance,
rtol 1e-4 / atol 1e-5, the conv sums over 8x8x4 windows rounding in
another order than XLA's.
"""
import dataclasses
import json
import os

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from agents_tpu import networks as jnetworks
from agents_tpu.agents.dqn import DqnAgent as JaxDqnAgent
from agents_tpu.environments import suites as jsuites
from agents_tpu.specs import array_spec as jspec
from agents_tpu.trajectories import time_step as jts
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu.utils import common as jcommon
from agents_tpu_torch.environments import suites as tsuites
from agents_tpu_torch.environments.test_envs import RandomPyEnvironment
from agents_tpu_torch.networks import make_q_network
from agents_tpu_torch.specs import array_spec as tspec
from agents_tpu_torch.trajectories import time_step as tts
from agents_tpu_torch.trajectories import trajectory as ttj
from agents_tpu_torch.utils import convert
from examples import dqn_atari_torch as ex
from test_torch_parity_utils import assert_close

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIH15 = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
NARROW = ((8, 8, 4), (16, 4, 2), (16, 3, 1))
CONV_RTOL, CONV_ATOL = 1e-4, 1e-5
S = 8


class _AtariStandIn(gym.Env):
  """What `AtariPreprocessing(..., grayscale_obs=True)` hands on: seeded
  uint8 frames, [84, 84, 1] with `grayscale_newaxis`, else [84, 84]; 6
  actions; episodes of 5 steps."""

  def __init__(self, grayscale_newaxis):
    shape = (84, 84, 1) if grayscale_newaxis else (84, 84)
    self.observation_space = gym.spaces.Box(0, 255, shape, np.uint8)
    self.action_space = gym.spaces.Discrete(6)
    self._rng = np.random.RandomState(0)
    self._t = 0

  def _frame(self):
    return self._rng.randint(0, 256, self.observation_space.shape).astype(
        np.uint8)

  def reset(self, *, seed=None, options=None):
    self._t = 0
    return self._frame(), {}

  def step(self, action):
    self._t += 1
    return self._frame(), 1.0, self._t >= 5, False, {}


@pytest.fixture
def atari_stand_in(monkeypatch):
  """`load_atari` of both packages over `_AtariStandIn`; returns the
  keyword arguments each passed to `AtariPreprocessing`."""
  calls = []

  def preprocessing(env, **kwargs):
    del env
    calls.append(kwargs)
    return _AtariStandIn(kwargs.get("grayscale_newaxis", False))

  monkeypatch.setattr(gym, "make", lambda game, **kwargs: None)
  monkeypatch.setattr(gym.wrappers, "AtariPreprocessing", preprocessing)
  monkeypatch.setattr(jsuites, "is_atari_available", lambda: True)
  monkeypatch.setattr(tsuites, "is_atari_available", lambda: True)
  return calls


def test_load_atari_stacks_frames_as_channels(atari_stand_in):
  """The port passes `grayscale_newaxis=True`, so `HistoryWrapper` stacks
  [84, 84, 1] frames into [84, 84, 4]; the JAX package's [84, 84] frames
  stack into [84, 336]. Channel k of the port's observation is the JAX
  observation's k-th block of 84 columns: the same frames, another
  layout (the first tiled 4 times at a reset)."""
  tenv = tsuites.load_atari("PongNoFrameskip-v4")
  jenv = jsuites.load_atari("PongNoFrameskip-v4")
  assert atari_stand_in[0]["grayscale_newaxis"] is True
  assert "grayscale_newaxis" not in atari_stand_in[1]
  assert tenv.observation_spec().shape == (84, 84, 4)
  assert tenv.observation_spec().dtype == np.uint8
  assert jenv.observation_spec().shape == (84, 336)
  obs_spec, act_spec = ex.atari_specs()
  assert np.all(tenv.observation_spec().minimum == obs_spec.minimum)
  assert np.all(tenv.observation_spec().maximum == obs_spec.maximum)
  assert (tenv.action_spec().shape, tenv.action_spec().dtype,
          int(tenv.action_spec().maximum)) == (act_spec.shape, act_spec.dtype,
                                               int(act_spec.maximum))
  steps = [(tenv.reset(), jenv.reset())]
  for _ in range(7):
    steps.append((tenv.step(np.int64(1)), jenv.step(np.int64(1))))
  for t, (tstep, jstep) in enumerate(steps):
    assert int(tstep.step_type) == int(jstep.step_type), t
    for k in range(4):
      np.testing.assert_array_equal(
          tstep.observation[:, :, k], jstep.observation[:, 84 * k:84 * (k + 1)])


def test_history_wrapper_stacks_an_84x84x1_env_as_channels():
  """The port's `HistoryWrapper` (as `load_atari` uses it) over a random
  [84, 84, 1] uint8 env: the newest frame last, earlier ones before it."""
  from agents_tpu_torch.environments import wrappers

  env = RandomPyEnvironment(
      tspec.BoundedArraySpec((84, 84, 1), np.uint8, 0, 255),
      tspec.BoundedArraySpec((), np.int64, 0, 5),
      episode_end_probability=0.0, seed=3)
  inner = RandomPyEnvironment(env.observation_spec(), env.action_spec(),
                              episode_end_probability=0.0, seed=3)
  stacked = wrappers.HistoryWrapper(env, history_length=4,
                                    tile_first_step_obs=True)
  assert stacked.observation_spec().shape == (84, 84, 4)
  frames = [inner.reset().observation]
  obs = [stacked.reset().observation]
  for _ in range(5):
    frames.append(inner.step(np.int64(0)).observation)
    obs.append(stacked.step(np.int64(0)).observation)
  np.testing.assert_array_equal(obs[0], np.concatenate([frames[0]] * 4, -1))
  np.testing.assert_array_equal(obs[5], np.concatenate(frames[2:6], -1))


def test_jax_q_network_mixes_rows_over_the_reference_layout():
  """The reference fault: over [84, 336] observations the JAX conv stack
  takes a batch [B, 84, 336] as one [H=B, W=84, C=336] image, so Q has
  one row per 8 env rows; the port's encoder refuses the 2-D leaf."""
  obs = jspec.BoundedArraySpec((84, 336), np.uint8, 0, 255)
  act = jspec.BoundedArraySpec((), np.int32, 0, 5)
  jnet = jnetworks.make_q_network(
      obs, act, conv_layer_params=MNIH15, fc_layer_params=(512,),
      preprocessing=lambda x: x.astype(jnp.float32) / 255.0)
  params = jnet.init_params(jax.random.key(0))
  for batch, rows in ((8, 1), (32, 4)):
    q, _ = jnet.apply(params, jnp.zeros((batch, 84, 336), jnp.uint8))
    assert q.shape == (rows, 6)
  with pytest.raises(ValueError, match=r"\[H, W, C\]"):
    make_q_network(tspec.BoundedArraySpec((84, 336), np.uint8, 0, 255),
                   tspec.BoundedArraySpec((), np.int64, 0, 5),
                   conv_layer_params=MNIH15, fc_layer_params=(512,),
                   device="cpu")


def jax_epsilon(cfg, train_step):
  """``dqn_atari.py:78-81``'s `epsilon_fn` at `train_step` (a closure
  inside its `train_eval`)."""
  frac = jnp.minimum(jnp.asarray(train_step).astype(jnp.float32)
                     / cfg.epsilon_decay_steps, 1.0)
  return 1.0 + frac * (cfg.epsilon_greedy_final - 1.0)


@pytest.mark.parametrize("train_step", [0, 1, 125_000, 250_000, 1_000_000])
def test_epsilon_fn_matches_jax(train_step):
  cfg = ex.Config()
  got = ex.epsilon_fn(cfg)(train_step)
  np.testing.assert_allclose(got, float(jax_epsilon(cfg, train_step)),
                             rtol=1e-6, atol=0)
  assert got == pytest.approx({0: 1.0, 1: 1.0 - 0.9 / 250_000,
                               125_000: 0.55}.get(train_step, 0.1))


def _narrow_config():
  return ex.Config(conv_layer_params=NARROW, fc_layer_params=(32,),
                   replay_capacity_frames=64, device="cpu")


def _agents(cfg):
  """(JAX agent as ``dqn_atari.py:83-92`` builds it, the port example's
  agent), both at `cfg`'s widths over the Atari specs."""
  jobs = jspec.BoundedArraySpec((84, 84, 4), np.uint8, 0, 255)
  jact = jspec.BoundedArraySpec((), np.int32, 0, 5)
  jtss = jts.time_step_spec(jobs)
  jnet = jnetworks.make_q_network(
      jtss.observation, jact, conv_layer_params=cfg.conv_layer_params,
      fc_layer_params=cfg.fc_layer_params,
      preprocessing=lambda x: x.astype(jnp.float32) / 255.0)
  jagent = JaxDqnAgent(
      jtss, jact, jnet, optax.adam(cfg.learning_rate, eps=cfg.adam_epsilon),
      epsilon_greedy=lambda step: jax_epsilon(cfg, step), gamma=cfg.gamma,
      target_update_tau=1.0, target_update_period=cfg.target_update_period,
      td_errors_loss_fn=jcommon.element_wise_huber_loss)
  tobs, tact = ex.atari_specs()
  tagent, _ = ex.build_agent(cfg, tts.time_step_spec(tobs), tact, "cpu")
  return jagent, tagent


def _experience(rng):
  st = rng.choice([0, 1, 2], size=(S, 2), p=[0.2, 0.6, 0.2])
  return dict(
      step_type=st.astype(np.int32),
      observation=rng.randint(0, 256, (S, 2, 84, 84, 4)).astype(np.uint8),
      action=rng.randint(0, 6, (S, 2)),
      next_step_type=rng.choice([0, 1, 2], size=(S, 2)).astype(np.int32),
      reward=rng.randn(S, 2).astype(np.float32),
      discount=rng.choice([0.0, 1.0], size=(S, 2)).astype(np.float32))


def _compare(jstate, tstate, msg):
  host = jax.device_get(jstate)
  adam = host.opt_state[0]
  for tag, tree, net in (("q", host.q_params, tstate.q_network),
                         ("target", host.target_q_params,
                          tstate.target_q_network)):
    expect = convert.q_params_to_state_dict(tree)
    for k, v in net.state_dict().items():
      assert_close(v, expect[k], CONV_RTOL, CONV_ATOL, f"{msg} {tag}.{k}")
  mu = convert.q_params_to_state_dict(adam.mu)
  nu = convert.q_params_to_state_dict(adam.nu)
  for p, name in zip(tstate.q_network.parameters(), mu):
    st = tstate.optimizer.state[p]
    assert_close(st["exp_avg"], mu[name], CONV_RTOL, CONV_ATOL,
                 f"{msg} mu.{name}")
    assert_close(st["exp_avg_sq"], nu[name], CONV_RTOL, 1e-9,
                 f"{msg} nu.{name}")
    assert float(st["step"]) == float(adam.count)
  assert tstate.train_step == int(host.train_step)


def test_agent_q_values_and_train_steps_match_jax():
  """The JAX agent's initial state carried across: Q values on 16 frames,
  then two Huber / Adam(eps 0.01) steps, losses and every tensor of the
  state at the conv tolerance."""
  cfg = _narrow_config()
  jagent, tagent = _agents(cfg)
  jstate = jagent.init(jax.random.key(0))
  host = jax.device_get(jstate)
  adam = host.opt_state[0]
  tstate = convert.load_dqn_agent_state(
      tagent.init(), convert.dqn_agent_state_to_torch(
          host.q_params, host.target_q_params, adam.mu, adam.nu, adam.count,
          host.train_step))
  rng = np.random.RandomState(4)
  frames = rng.randint(0, 256, (16, 84, 84, 4)).astype(np.uint8)
  jq, _ = jagent.q_network.apply(host.q_params, jnp.asarray(frames))
  with torch.no_grad():
    tq, _ = tstate.q_network(torch.from_numpy(frames))
  assert_close(tq, jq, CONV_RTOL, CONV_ATOL, "q values")
  jtrain = jax.jit(jagent.train)
  for step in (1, 2):
    e = _experience(rng)
    jexp = jtj.Trajectory(policy_info=(), **{
        k: jnp.asarray(v.astype(np.int32) if k == "action" else v)
        for k, v in e.items()})
    texp = ttj.Trajectory(policy_info=(), **{
        k: torch.from_numpy(v) for k, v in e.items()})
    jstate, jinfo = jtrain(jstate, jexp)
    tstate, tinfo = tagent.train(tstate, texp)
    assert_close(tinfo.loss, jinfo.loss, CONV_RTOL, CONV_ATOL,
                 f"step {step} loss")
    assert_close(tinfo.extra.td_loss, jinfo.extra.td_loss, CONV_RTOL,
                 CONV_ATOL, f"step {step} td_loss")
    _compare(jstate, tstate, f"step {step}")
  params = tagent.collect_policy_params(tstate)
  assert tagent.collect_policy._epsilon(params) == ex.epsilon_fn(cfg)(2)


def test_without_ale_py_raises_the_jax_examples_error():
  from examples import dqn_atari

  assert not tsuites.is_atari_available()
  with pytest.raises(ImportError) as jax_error:
    dqn_atari.train_eval(dqn_atari.Config())
  with pytest.raises(ImportError) as port_error:
    ex.build_loop(ex.Config(device="cpu"))
  assert str(port_error.value) == str(jax_error.value)


def _random_atari_factory():
  seeds = iter(range(1000))
  return lambda: RandomPyEnvironment(*ex.atari_specs(),
                                     episode_end_probability=0.0,
                                     max_duration=500, seed=next(seeds))


def test_smoke_run_over_random_atari_envs(tmp_path, capsys):
  """The JAX example's `--smoke` over 8 random Atari-spec envs at a narrow
  conv width and a 4,096-frame ring: the train steps stay within the UTD,
  ``train.jsonl`` holds the progress, and the saved greedy policy (its
  `torch.export` program and `load_policy` with the policy object) acts
  as the live one."""
  from agents_tpu_torch.policies.policy_saver import (load_manifest,
                                                      load_policy)

  root = str(tmp_path / "atari")
  out = ex.main(["dqn_atari_torch.py", "--smoke", "--device", "cpu",
                 f"--cfg.root_dir={root}",
                 "--cfg.replay_capacity_frames=4096",
                 "--cfg.conv_layer_params=8x8x4,16x4x2,16x3x1",
                 "--cfg.fc_layer_params=32"],
                make_env=_random_atari_factory())
  printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  cfg = dataclasses.replace(_narrow_config(), replay_capacity_frames=4096,
                            **ex.SMOKE)
  assert out["env_steps"] == printed["env_steps"] == 4000
  assert out["trainer_drained"]
  min_frames = cfg.initial_collect_ticks * cfg.env_batch_size
  assert 0 < out["train_steps"] <= cfg.utd_ratio * (4000 - min_frames) + 8
  assert out["agent_state"].train_step == out["train_steps"]
  with open(os.path.join(root, "train.jsonl")) as f:
    lines = [json.loads(line) for line in f]
  assert [r["step"] for r in lines] == list(range(800, 4001, 800))
  assert all("AverageReturn" in r for r in lines)

  assert out["policy_dir"] == os.path.join(root, "policies", "greedy")
  manifest = load_manifest(out["policy_dir"])
  assert manifest["train_step"] == out["train_steps"]
  assert manifest["policy_config"] is None     # the 1/255 lambda
  assert manifest["torch_export"] == "batch-polymorphic"
  tobs, tact = ex.atari_specs()
  agent, _ = ex.build_agent(cfg, tts.time_step_spec(tobs), tact, "cpu")
  frames = np.random.RandomState(5).randint(
      0, 256, (16, 84, 84, 4)).astype(np.uint8)
  step = tts.TimeStep(step_type=np.zeros(16, np.int32),
                      reward=np.zeros(16, np.float32),
                      discount=np.ones(16, np.float32), observation=frames)
  with torch.no_grad():
    live = agent.policy.action(
        out["agent_state"].q_network,
        tts.TimeStep(**{k: torch.from_numpy(getattr(step, k)) for k in (
            "step_type", "reward", "discount", "observation")})
    ).action.numpy()
  saved = load_policy(out["policy_dir"], policy=agent.policy, device="cpu")
  np.testing.assert_array_equal(saved.action(step).action, live)
  import importlib.util
  spec = importlib.util.spec_from_file_location(
      "atari_artifact_loader", os.path.join(out["policy_dir"], "loader.py"))
  loader = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(loader)
  (exported,), _ = loader.ExportedPolicy(out["policy_dir"],
                                         platform="cpu").action([frames])
  np.testing.assert_array_equal(exported, live)
