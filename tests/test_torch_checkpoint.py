"""Checkpoint and resume (`agents_tpu_torch.train.checkpointer`).

Every loop the port has: run N1 + N2 iterations without a break, and
against it N1 iterations, `save`, a fresh loop built from the same seed
(a new process would rebuild it), `restore` into its initial state, and
N2 more. The port updates its state in place, so the two runs are two
loops built from one seed, not one initial state run twice. The resumed
losses and every tensor, number and generator state of the final state
must be `torch.equal` to the uninterrupted run's: resume is bit for bit
invisible (as `tests/test_checkpoint_resume.py:45` holds for the JAX
package). Further tests hold the `Checkpointer` to the JAX class's
semantics (`agents_tpu/train/checkpointer.py`), the file to
``torch.load(..., weights_only=True)``, and the DQN example to resuming
from its own `root_dir`.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from agents_tpu_torch import metrics
from agents_tpu_torch.agents.dqn import DdqnAgent
from agents_tpu_torch.agents.reinforce import ReinforceAgent
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.environments.classic import CartPole
from agents_tpu_torch.networks import (make_actor_distribution_network,
                                       make_q_network, make_q_rnn_network,
                                       make_value_network)
from agents_tpu_torch.replay_buffers import UniformReplay
from agents_tpu_torch.train import (Checkpointer, FusedTrainLoop,
                                    OnPolicyTrainLoop)
from agents_tpu_torch.train.checkpointer import capture, restore_into
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws
from examples import dqn_cartpole_torch, dqn_pixels_torch, ppo_cartpole_torch
from examples import sac_pendulum_torch, td3_pendulum_torch

torch.set_num_threads(1)

CPU = dict(device="cpu")
PENDULUM = dict(env_batch_size=4, replay_capacity=64, sample_batch_size=16,
                train_steps_per_iteration=2, actor_fc_layers=(16, 16),
                critic_joint_fc_layers=(16, 16), initial_collect_steps=16,
                max_episode_steps=20, **CPU)
ON_POLICY = dict(env_batch_size=4, rollout_length=12, max_episode_steps=10,
                 num_epochs=2, num_minibatches=2, actor_fc_layers=(16,),
                 value_fc_layers=(16,), return_buffer=5, **CPU)


def _cartpole_dqn(agent_cls, q_network_fn, train_sequence_length=None):
  """A CartPole fused loop of `agent_cls` over `q_network_fn(tss, asp)`."""
  env = BatchedTorchEnv(CartPole(max_episode_steps=20), 4, device="cpu")
  tss, asp = env.time_step_spec(), env.action_spec()
  agent = agent_cls(tss, asp, q_network_fn(tss, asp),
                    lambda p: torch.optim.Adam(p, lr=1e-3), gamma=0.99,
                    target_update_tau=0.05, target_update_period=2,
                    train_sequence_length=train_sequence_length, **CPU)
  replay = UniformReplay(tj.trajectory_spec(tss, asp), 4, 64, **CPU)
  return FusedTrainLoop(env, agent, replay,
                        metrics=metrics.standard_collect_metrics(5),
                        sample_batch_size=16, **CPU)


def _generator():
  return torch.Generator().manual_seed(3)


def _reinforce():
  env = BatchedTorchEnv(CartPole(max_episode_steps=10), 4, device="cpu")
  tss, asp = env.time_step_spec(), env.action_spec()
  generator = _generator()
  agent = ReinforceAgent(
      tss, asp,
      make_actor_distribution_network(tss.observation, asp,
                                      fc_layer_params=(16,), generator=generator,
                                      **CPU),
      lambda p: torch.optim.Adam(p, lr=1e-3),
      value_network=make_value_network(tss.observation, (16,),
                                       generator=generator, **CPU),
      gamma=0.99, **CPU)
  return OnPolicyTrainLoop(env, agent, metrics.standard_collect_metrics(5),
                           rollout_length=12, **CPU)


# name: (build the loop, initial collect steps or None for on-policy)
LOOPS = {
    "dqn": (lambda: dqn_cartpole_torch.build_loop(dqn_cartpole_torch.Config(
        env_batch_size=4, replay_capacity=64, sample_batch_size=16,
        fc_layer_params=(16,), **CPU)), 16),
    "ddqn": (lambda: _cartpole_dqn(DdqnAgent, lambda tss, asp: make_q_network(
        tss.observation, asp, fc_layer_params=(16,), generator=_generator(),
        **CPU)), 16),
    "d3qn": (lambda: _cartpole_dqn(DdqnAgent, lambda tss, asp: make_q_network(
        tss.observation, asp, fc_layer_params=(16,), dueling=True,
        generator=_generator(), **CPU)), 16),
    "c51": (lambda: dqn_pixels_torch.build_loop(dqn_pixels_torch.Config(
        **{**dqn_pixels_torch.CATCH, "agent": "c51", "env_batch_size": 4,
           "replay_capacity": 32, "sample_batch_size": 8,
           "conv_layer_params": ((4, 3, 1),), "fc_layer_params": (16,),
           "num_atoms": 11, **CPU})), 8),
    "sac": (lambda: sac_pendulum_torch.build_loop(sac_pendulum_torch.Config(
        **PENDULUM)), 16),
    "td3": (lambda: td3_pendulum_torch.build_loop(td3_pendulum_torch.Config(
        agent="td3", **PENDULUM)), 16),
    "ddpg": (lambda: td3_pendulum_torch.build_loop(td3_pendulum_torch.Config(
        agent="ddpg", **PENDULUM)), 16),
    "qtopt": (lambda: td3_pendulum_torch.build_loop(td3_pendulum_torch.Config(
        agent="qtopt", **PENDULUM)), 16),
    "rnn_ddqn": (lambda: _cartpole_dqn(
        DdqnAgent, lambda tss, asp: make_q_rnn_network(
            tss.observation, asp, input_fc_layer_params=(8,), lstm_size=8,
            output_fc_layer_params=(8,), generator=_generator(), **CPU),
        train_sequence_length=4), 16),
    "ppo": (lambda: ppo_cartpole_torch.build_loop(ppo_cartpole_torch.Config(
        **ON_POLICY)), None),
    "reinforce": (_reinforce, None),
    "ppo_rnn": (lambda: ppo_cartpole_torch.build_loop(ppo_cartpole_torch.Config(
        **{**ON_POLICY, "lstm_size": 8, "actor_fc_layers": (8,),
           "value_fc_layers": (8,), "lstm_output_fc_layers": (8,)})), None),
}
N1, N2 = 4, 4


def _init(loop, initial_collect_steps):
  if initial_collect_steps is None:
    return loop.init(seed=5)
  return loop.init(seed=5, initial_collect_steps=initial_collect_steps)


def assert_nests_equal(a, b, path="state"):
  """Two `capture`s hold equal tensors (`torch.equal`) and values."""
  assert type(a) is type(b), path
  if isinstance(a, torch.Tensor):
    assert a.dtype == b.dtype and torch.equal(a, b), path
  elif isinstance(a, dict):
    assert list(a) == list(b), path
    for k in a:
      assert_nests_equal(a[k], b[k], f"{path}[{k!r}]")
  elif isinstance(a, (list, tuple)):
    assert len(a) == len(b), path
    for i, (x, y) in enumerate(zip(a, b)):
      assert_nests_equal(x, y, f"{path}[{i}]")
  else:
    assert a == b, path


@pytest.mark.parametrize("name", list(LOOPS))
def test_resumed_loop_is_bit_identical(name, tmp_path):
  build, initial = LOOPS[name]
  loop = build()
  state = _init(loop, initial)
  state, first = loop.run(state, N1)
  state, second = loop.run(state, N2)
  uninterrupted, final = torch.cat([first, second]), capture(state)

  loop = build()
  state = _init(loop, initial)
  state, first = loop.run(state, N1)
  checkpointer = Checkpointer(str(tmp_path / "ck"))
  assert checkpointer.save(N1, state)
  del loop, state

  loop = build()
  template = _init(loop, initial)
  restored = checkpointer.restore(template)
  restored, second = loop.run(restored, N2)
  resumed = torch.cat([first, second])

  assert torch.isfinite(resumed).all()
  assert torch.equal(uninterrupted, resumed)
  assert_nests_equal(final, capture(restored))
  # The restore went into the new loop's own objects (the agent trains
  # the networks its state holds).
  agent_state = restored.agent_state
  for field in dataclasses.fields(agent_state):
    value = getattr(agent_state, field.name)
    if isinstance(value, torch.optim.Optimizer):
      params = {id(p) for g in value.param_groups for p in g["params"]}
      assert params <= {id(p) for f in dataclasses.fields(agent_state)
                        for p in _parameters(getattr(agent_state, f.name))}


def _parameters(value):
  if isinstance(value, torch.nn.Module):
    return list(value.parameters())
  if isinstance(value, torch.nn.Parameter):
    return [value]
  return []


def test_recurrent_loops_restore_the_lstm_carry_and_episodes(tmp_path):
  """The driver's LSTM carry and the in-flight episodes come back."""
  for name in ("rnn_ddqn", "ppo_rnn"):
    build, initial = LOOPS[name]
    loop = build()
    state, _ = loop.run(_init(loop, initial), 3)
    carry = [c.clone() for c in _flat(state.driver_state.policy_state)]
    assert any(float(c.abs().max()) > 0 for c in carry)
    checkpointer = Checkpointer(str(tmp_path / name))
    checkpointer.save(3, state)
    fresh = build()
    restored = checkpointer.restore(_init(fresh, initial))
    for a, b in zip(_flat(restored.driver_state.policy_state), carry,
                    strict=True):
      assert torch.equal(a, b)
    assert torch.equal(restored.driver_state.time_step.observation,
                       state.driver_state.time_step.observation)
    assert torch.equal(restored.driver_state.env_state.steps,
                       state.driver_state.env_state.steps)


def _flat(nest):
  from agents_tpu_torch.utils import nest_utils
  return nest_utils.flatten(nest)


# -- Checkpointer semantics ----------------------------------------------------


def _small_state(value=0.0):
  return {"w": torch.full((3,), value), "count": 0,
          "draws": Draws(1, "cpu")}


def test_checkpointer_semantics(tmp_path):
  """As the JAX class: save returns False for a saved step, the newest
  `max_to_keep` stay, restore of an empty directory raises,
  initialize_or_restore returns the template unchanged when empty."""
  ck = Checkpointer(str(tmp_path / "rel" / ".." / "ck"), max_to_keep=2)
  assert ck.directory == os.path.abspath(str(tmp_path / "ck"))
  assert ck.latest_step() is None
  template = _small_state()
  assert ck.initialize_or_restore(template) is template
  with pytest.raises(FileNotFoundError):
    ck.restore(template)
  for step in (1, 2, 3):
    state = _small_state(float(step))
    state["count"] = step
    assert ck.save(step, state)
  assert not ck.save(3, _small_state(9.0), force=True)
  assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
  restored = ck.initialize_or_restore(_small_state())
  assert restored["count"] == 3 and torch.equal(restored["w"],
                                                torch.full((3,), 3.0))
  assert ck.restore(_small_state(), step=2)["count"] == 2
  with pytest.raises(FileNotFoundError):
    ck.restore(_small_state(), step=1)
  ck.wait()
  ck.close()


def test_checkpoint_file_loads_with_weights_only(tmp_path):
  """The file is a nest of plain dicts, lists, CPU tensors and numbers;
  a generator state is a ByteTensor; a save cut before its rename leaves
  only a temporary file that no step counts."""
  build, initial = LOOPS["sac"]
  loop = build()
  state = _init(loop, initial)
  ck = Checkpointer(str(tmp_path))
  ck.save(7, state)
  payload = torch.load(os.path.join(ck.directory, "7.pt"),
                       weights_only=True)
  assert payload["step"] == 7
  saved = payload["state"]
  assert saved["replay_state"]["count"] == state.replay_state.count
  assert saved["draws"]["generator_state"].dtype == torch.uint8
  agent = saved["agent_state"]
  assert set(agent["actor_optimizer"]) == {"state", "param_groups"}
  assert agent["log_alpha"].device.type == "cpu"
  with open(os.path.join(ck.directory, ".8.pt.tmp"), "wb") as f:
    f.write(b"cut")
  assert ck.all_steps() == [7]


def test_capture_refuses_replayed_draws_and_mismatched_templates():
  with pytest.raises(TypeError, match="ReplayDraws"):
    capture({"draws": ReplayDraws({"x": [np.zeros(2)]})})
  with pytest.raises(TypeError, match="RecordingDraws"):
    capture(RecordingDraws(Draws(0, "cpu")))
  saved = capture(_small_state())
  with pytest.raises(ValueError, match=r"\(3,\)"):
    restore_into({"w": torch.zeros(4), "count": 0, "draws": Draws(1, "cpu")},
                 saved)
  with pytest.raises(ValueError, match="keys"):
    restore_into({"w": torch.zeros(3)}, saved)


def test_restore_writes_in_place_and_unties_aliased_template_tensors():
  """A tensor is copied into the template's own; a second template leaf on
  the same storage gets a tensor of its own."""
  shared = torch.zeros(2)
  template = {"a": shared, "b": shared, "n": 1}
  out = restore_into(template, {"a": torch.ones(2), "b": torch.full((2,), 2.0),
                                "n": 4})
  assert out["a"] is shared and torch.equal(shared, torch.ones(2))
  assert torch.equal(out["b"], torch.full((2,), 2.0)) and out["n"] == 4


# -- the DQN example resumes from its own root_dir -----------------------------


def _example_config(root_dir, num_iterations):
  return dqn_cartpole_torch.Config(
      root_dir=str(root_dir), env_batch_size=4, num_iterations=num_iterations,
      initial_collect_steps=8, replay_capacity=32, sample_batch_size=8,
      fc_layer_params=(8,), log_interval=10, checkpoint_interval=20,
      num_eval_episodes=4, device="cpu")


def _records(root_dir):
  with open(os.path.join(root_dir, "train.jsonl")) as f:
    return [json.loads(line) for line in f]


def test_dqn_example_resumes_from_its_root_dir(tmp_path):
  """60 iterations at once, against 30, then the same command asked for
  60: the second run starts from the checkpoint of step 30 and logs the
  same losses at 40, 50 and 60."""
  dqn_cartpole_torch.train_eval(_example_config(tmp_path / "a", 60))
  ck = Checkpointer(str(tmp_path / "a" / "train" / "checkpoints"))
  assert ck.all_steps() == [20, 40, 60]

  root = tmp_path / "b"
  dqn_cartpole_torch.train_eval(_example_config(root, 30))
  ck = Checkpointer(str(root / "train" / "checkpoints"))
  assert ck.all_steps() == [20, 30]
  dqn_cartpole_torch.train_eval(_example_config(root, 60))
  assert ck.all_steps() == [30, 40, 60]

  losses = lambda records: {r["step"]: r["loss"] for r in records  # noqa
                            if "loss" in r}
  whole, resumed = losses(_records(tmp_path / "a")), _records(root)
  assert [r["step"] for r in resumed if "loss" in r] == [10, 20, 30, 40, 50,
                                                          60]
  assert sum("EvalAverageReturn" in r for r in resumed) == 2
  assert losses(resumed) == whole
