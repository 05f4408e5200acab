"""The DQN train step as one CUDA graph (`agents/dqn/dqn_agent.py`): where
it engages, what its key tells apart, and that a replayed step's LossInfo
is its own.

No CUDA graph can be captured on the CPU. There the routing runs with a
stand-in graph that recomputes the step on the static inputs and writes
its outputs into the static output buffers in place, as a replay does,
and with the side stream left out. The tests marked `card` hold the real
graph against the eager step on an NVIDIA card and skip without one:

    python3 -m pytest tests/test_torch_dqn_graph.py -m card
"""
import copy
import dataclasses
import gc
import threading
import time

import numpy as np
import pytest
import torch

from agents_tpu_torch import networks
from agents_tpu_torch.agents.dqn import DqnAgent
from agents_tpu_torch.agents.dqn import dqn_agent
from agents_tpu_torch.environments import suite_gym
from agents_tpu_torch.environments.batched_py_environment import \
    BatchedPyEnvironment
from agents_tpu_torch.replay_buffers import UniformReplay
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.train import AsyncHostDeviceTrainLoop
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import nest_utils, profiling
from examples.dqn_pixels_torch import Config, build_loop

torch.set_num_threads(1)

# A small pixel loop: 20x20 frames through the Nature convolutions, a
# target update every 4 train steps.
SMALL = dict(pixels_size=20, env_batch_size=8, replay_capacity=64,
             sample_batch_size=16, initial_collect_steps=16,
             target_update_period=4, fc_layer_params=(64,))


def _pixel_loop(device="cpu", agent="dqn", **overrides):
  cfg = Config(device=device, agent=agent, **{**SMALL, **overrides})
  loop = build_loop(cfg)
  return loop, loop.init(seed=cfg.seed,
                         initial_collect_steps=cfg.initial_collect_steps)


def _batches(loop, state, n, size=None):
  size = size or loop.sample_batch_size
  return [loop.replay.sample(state.replay_state, state.draws, size,
                             num_steps=2)[0] for _ in range(n)]


def _leaves(agent_state):
  """Every tensor a train step changes: parameters, target parameters and
  the optimizer's state, by name."""
  out = {f"q.{k}": v for k, v in agent_state.q_network.state_dict().items()}
  out.update({f"target.{k}": v for k, v in
              agent_state.target_q_network.state_dict().items()})
  opt = agent_state.optimizer
  params = [p for g in opt.param_groups for p in g["params"]]
  for i, p in enumerate(params):
    for k, v in opt.state.get(p, {}).items():
      out[f"opt.{i}.{k}"] = torch.as_tensor(v)
  return out


def _assert_identical(a, b, what=""):
  assert set(a) == set(b), what
  for k in a:
    assert torch.equal(a[k], b[k]), f"{what} {k}"


def _assert_infos_identical(a, b):
  for x, y in zip(nest_utils.flatten(a), nest_utils.flatten(b)):
    assert x.dtype == y.dtype and torch.equal(x, y)


# ----------------------------------------------------------------- CPU


def _small_agent(device="cpu", recurrent=False, capturable=True):
  obs = array_spec.ArraySpec((3,), np.float32)
  act = array_spec.BoundedArraySpec((), np.int32, 0, 1)
  if recurrent:
    net = networks.make_q_rnn_network(obs, act, lstm_size=4, device="cpu")
  else:
    net = networks.make_q_network(obs, act, fc_layer_params=(4,),
                                  device="cpu")
  return DqnAgent(ts.time_step_spec(obs), act, net,
                  lambda p: torch.optim.Adam(p, capturable=capturable),
                  device=device)


ENGAGES = {
    "cuda_capturable_feed_forward": (dict(), "cuda", True),
    "cpu": (dict(), "cpu", False),
    "not_capturable": (dict(capturable=False), "cuda", False),
    "mesh": (dict(), "cuda", False),
    "recurrent": (dict(recurrent=True), "cuda", False),
    "off_the_main_thread": (dict(), "cuda", False),
}


@pytest.mark.parametrize("case", sorted(ENGAGES))
def test_the_graph_engages_only_where_one_is_valid(case):
  """The predicate reads the device, every param group's `capturable`,
  the mesh, the Q network's `state_spec` and the thread it runs on. The
  agents are built on the CPU; the device the predicate reads is set
  afterwards."""
  kwargs, device, engages = ENGAGES[case]
  agent = _small_agent(**kwargs)
  agent.device = torch.device(device)
  if case == "mesh":
    agent.mesh = object()
  agent_state, got = agent.init(), []
  if case == "off_the_main_thread":
    thread = threading.Thread(
        target=lambda: got.append(agent._graphable(agent_state)))
    thread.start()
    thread.join()
  else:
    got.append(agent._graphable(agent_state))
  assert got == [engages]


def test_the_async_loop_trains_off_the_main_thread():
  """`AsyncHostDeviceTrainLoop` calls `train` from its trainer thread
  while its collector launches work from the caller's, so its DQN steps
  never engage the graph (the predicate's thread case above)."""
  env = BatchedPyEnvironment([suite_gym.load("CartPole-v1")
                              for _ in range(2)])
  env.seed(0)
  tss, asp = env.time_step_spec(), env.action_spec()
  net = networks.make_q_network(tss.observation, asp, fc_layer_params=(8,),
                                device="cpu")
  agent = DqnAgent(tss, asp, net, torch.optim.Adam, device="cpu")
  replay = UniformReplay(tj.trajectory_spec(tss, asp), 2, 64, device="cpu")
  loop = AsyncHostDeviceTrainLoop(env, agent, replay, sample_batch_size=4,
                                  train_steps_per_call=2,
                                  min_replay_frames=16, device="cpu")
  on_main, train = [], agent.train

  def spy(*args, **kwargs):
    on_main.append(threading.current_thread() is threading.main_thread())
    return train(*args, **kwargs)

  agent.train = spy
  loop.run(total_env_batch_steps=40, initial_random_steps=0,
           progress_fn=lambda loop: time.sleep(0.002), progress_every=1)
  assert on_main and not any(on_main)
  assert not loop._trainer_thread.is_alive()


def test_a_cpu_loop_trains_eagerly_and_replays_nothing():
  loop, state = _pixel_loop(dtype="float32")
  with profiling.record() as rec:
    loop.run(state, 3)
  counters = rec.summary()["counters"]
  assert counters["agent.train_steps"] == 3
  assert "agent.graph_replays" not in counters
  assert loop.agent._train_graph is None
  assert loop.agent._warmed_up is None


class _StandInGraph:
  """A CUDA graph's replay on the CPU: the step runs on the static inputs
  and writes its outputs into the static output buffers in place (the
  first replay makes them)."""

  def __init__(self, train_graph, step):
    self.train_graph, self.step = train_graph, step
    self.replays = 0

  def replay(self):
    g = self.train_graph
    loss, extra = self.step(g.experience, g.weights)
    if g.loss is None:
      g.loss, g.extra = loss, extra
    else:
      for static, x in zip(nest_utils.flatten((g.loss, g.extra)),
                           nest_utils.flatten((loss, extra))):
        static.copy_(x)
    self.replays += 1


@pytest.fixture
def stand_in(monkeypatch):
  """The graph path on the CPU: the predicate holds, the side stream is
  left out (its calls are counted) and a capture installs a stand-in."""
  calls = {"warmups": 0, "captures": 0}

  def on_side_stream(device, fn, *args):
    calls["warmups"] += 1
    return fn(*args)

  def capture(self, device, step):
    calls["captures"] += 1
    self.graph = _StandInGraph(self, step)

  monkeypatch.setattr(dqn_agent, "_on_side_stream", on_side_stream)
  monkeypatch.setattr(dqn_agent._TrainGraph, "capture", capture)
  monkeypatch.setattr(DqnAgent, "_graphable", lambda self, state: True)
  return calls


@pytest.mark.parametrize("agent", ["dqn", "c51"])
def test_replayed_steps_equal_eager_steps_bit_for_bit(stand_in, agent):
  """Six iterations of the pixel loop through `run_with_info` (step 1
  warms up, step 2 captures, steps 2-6 replay; the target updates at step
  4) against the same loop trained eagerly: every loss, extra and leaf
  equal."""
  loop, state = _pixel_loop(agent=agent, dtype="float32")
  eager_loop, eager_state = _pixel_loop(agent=agent, dtype="float32")
  eager_loop.agent._graphable = lambda state: False
  with profiling.record() as rec:
    state, infos = loop.run_with_info(state, 6)
  eager_state, eager_infos = eager_loop.run_with_info(eager_state, 6)
  _assert_infos_identical(infos, eager_infos)
  assert len(set(infos.loss.tolist())) == 6
  _assert_identical(_leaves(state.agent_state),
                    _leaves(eager_state.agent_state))
  assert stand_in == {"warmups": 1, "captures": 1}
  assert rec.summary()["counters"] == {"agent.train_steps": 6,
                                       "agent.graph_replays": 5}


def test_a_replayed_loss_info_shares_no_buffer_with_the_graph(stand_in):
  """Each replay's LossInfo is a clone: the next replay, which rewrites
  the static output buffers, leaves the earlier LossInfos as they were."""
  loop, state = _pixel_loop(dtype="float32")
  agent, agent_state = loop.agent, state.agent_state
  infos = []
  for batch in _batches(loop, state, 4):
    agent_state, info = agent.train(agent_state, batch)
    infos.append((info, copy.deepcopy(info)))
  graph = agent._train_graph
  statics = {t.untyped_storage().data_ptr()
             for t in nest_utils.flatten((graph.loss, graph.extra))}
  for info, kept in infos[1:]:
    for t in nest_utils.flatten(info):
      assert t.untyped_storage().data_ptr() not in statics
    _assert_infos_identical(info, kept)
  assert len({float(info.loss) for info, _ in infos}) == 4


def test_a_loss_on_a_state_copy_keeps_nothing_of_the_copy(stand_in):
  """`Agent.loss` trains a deep copy of the state: the warm-up it records
  holds the copy only weakly, so the copy is freed when the loss returns,
  and the captured graph is the step's own."""
  loop, state = _pixel_loop(dtype="float32")
  agent, agent_state = loop.agent, state.agent_state
  batches = _batches(loop, state, 3)
  for batch in batches[:2]:
    agent_state, _ = agent.train(agent_state, batch)
  graph = agent._train_graph
  info = agent.loss(agent_state, batches[2])
  gc.collect()
  network, target, optimizer = (ref() for ref in agent._warmed_up[:3])
  assert network is target is optimizer is None
  assert torch.isfinite(info.loss)
  agent_state, _ = agent.train(agent_state, batches[2])
  assert agent._train_graph is graph and graph.graph.replays == 2


def _new_shape(agent, agent_state, batch):
  return agent_state, nest_utils.tree_map(lambda x: x[:8], batch)


def _state_copy(agent, agent_state, batch):
  return copy.deepcopy(agent_state), batch


def _new_learning_rate(agent, agent_state, batch):
  agent_state.optimizer.param_groups[0]["lr"] *= 0.5
  return agent_state, batch


def _reloaded_optimizer(agent, agent_state, batch):
  opt = agent_state.optimizer
  opt.load_state_dict(opt.state_dict())
  return agent_state, batch


def _new_dtype(agent, agent_state, batch):
  return agent_state, dataclasses.replace(
      batch, reward=batch.reward.to(torch.float64))


CHANGES = {"new_shape": _new_shape, "state_copy": _state_copy,
           "new_learning_rate": _new_learning_rate,
           "reloaded_optimizer": _reloaded_optimizer,
           "new_dtype": _new_dtype}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_a_step_the_graph_was_not_captured_for_runs_eagerly(stand_in,
                                                            change):
  """After the capture, a step on other objects, shapes, dtypes or
  hyperparameters runs eagerly (a warm-up of its own), equal to the
  eager step, and the captured graph stays as it was."""
  loop, state = _pixel_loop(dtype="float32")
  agent, agent_state = loop.agent, state.agent_state
  batches = _batches(loop, state, 3)
  for batch in batches[:2]:
    agent_state, _ = agent.train(agent_state, batch)
  graph = agent._train_graph
  assert graph is not None and graph.graph.replays == 1
  agent_state, batch = CHANGES[change](agent, agent_state, batches[2])
  twin = copy.deepcopy(agent_state)
  with profiling.record() as rec:
    _, info = agent.train(agent_state, batch)
  _, eager_info = agent._train_eagerly(twin, batch)
  _assert_infos_identical(info, eager_info)
  assert stand_in == {"warmups": 2, "captures": 1}
  assert "agent.graph_replays" not in rec.summary()["counters"]
  assert agent._train_graph is graph and graph.graph.replays == 1


def test_a_new_shape_twice_captures_its_own_graph_and_no_step_repeats(
    stand_in):
  """A batch of a new shape, twice: a warm-up, then its own capture; the
  steps count one each."""
  loop, state = _pixel_loop(dtype="float32")
  agent, agent_state = loop.agent, state.agent_state
  batches = _batches(loop, state, 2) + _batches(loop, state, 2, size=8)
  with profiling.record() as rec:
    for batch in batches:
      agent_state, _ = agent.train(agent_state, batch)
  assert agent_state.train_step == 4
  assert stand_in == {"warmups": 2, "captures": 2}
  assert rec.summary()["counters"] == {"agent.train_steps": 4,
                                       "agent.graph_replays": 2}
  assert agent._train_graph.experience.observation.shape[0] == 8


# ---------------------------------------------------------------- card


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA card")
  deterministic = torch.backends.cudnn.deterministic
  tf32 = (torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32)
  torch.backends.cudnn.deterministic = True
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  yield torch.device("cuda")
  torch.backends.cudnn.deterministic = deterministic
  (torch.backends.cuda.matmul.allow_tf32,
   torch.backends.cudnn.allow_tf32) = tf32


def _graph_against_eager(agent, agent_state, batches):
  """Train `agent_state` through `agent.train` and a copy of it eagerly
  on the same batches; every step's LossInfo and the final leaves must
  be identical. Returns (graph state, replays counted)."""
  eager_state = copy.deepcopy(agent_state)
  with profiling.record() as rec:
    for i, batch in enumerate(batches):
      agent_state, info = agent.train(agent_state, batch)
      eager_state, eager_info = agent._train_eagerly(eager_state, batch)
      for name, x, y in zip(("loss", "extra"), (info.loss, info.extra),
                            (eager_info.loss, eager_info.extra)):
        for a, b in zip(nest_utils.flatten(x), nest_utils.flatten(y)):
          diff = (a.float() - b.float()).abs().max().item()
          assert torch.equal(a, b), f"step {i + 1} {name}: {diff}"
  torch.cuda.synchronize()
  _assert_identical(_leaves(agent_state), _leaves(eager_state), "leaves")
  return agent_state, rec.summary()["counters"].get("agent.graph_replays")


@pytest.mark.card
@pytest.mark.parametrize("agent", ["dqn", "c51"])
def test_card_twenty_replayed_steps_equal_eager_steps(card, agent):
  """20 train steps through the pixel example's agent (capturable Adam):
  step 1 warms up, steps 2-20 replay one graph; against the same state
  trained eagerly on the same batches, bit for bit."""
  loop, state = _pixel_loop("cuda", agent=agent)
  assert loop.agent._graphable(state.agent_state)
  batches = _batches(loop, state, 20)
  _, replays = _graph_against_eager(loop.agent, state.agent_state, batches)
  assert replays == 19


@pytest.mark.card
def test_card_run_with_info_gives_each_iteration_its_own_loss(card):
  """`run_with_info` over 3 iterations (warm-up, capture and replay,
  replay) gives 3 distinct losses, equal to an eager loop's."""
  loop, state = _pixel_loop("cuda")
  eager_loop, eager_state = _pixel_loop("cuda")
  eager_loop.agent._graphable = lambda state: False
  with profiling.record() as rec:
    state, infos = loop.run_with_info(state, 3)
  eager_state, eager_infos = eager_loop.run_with_info(eager_state, 3)
  _assert_infos_identical(infos, eager_infos)
  assert len(set(infos.loss.tolist())) == 3
  assert rec.summary()["counters"]["agent.graph_replays"] == 2


@pytest.mark.card
def test_card_target_update_fires_at_its_period_on_the_graph_path(card):
  """With a period of 4: after replayed step 3 the target is still the
  initial network, after replayed step 4 it is the online network."""
  loop, state = _pixel_loop("cuda")
  agent, agent_state = loop.agent, state.agent_state
  initial = {k: v.clone() for k, v in
             agent_state.q_network.state_dict().items()}
  for i, batch in enumerate(_batches(loop, state, 4)):
    agent_state, _ = agent.train(agent_state, batch)
    online = agent_state.q_network.state_dict()
    target = agent_state.target_q_network.state_dict()
    if i == 2:
      _assert_identical(target, initial, "before the update")
      assert not all(torch.equal(online[k], target[k]) for k in online)
    if i == 3:
      _assert_identical(target, online, "after the update")
  assert agent._train_graph.graph is not None


@pytest.mark.card
def test_card_a_new_batch_shape_does_not_replay_the_old_graph(card):
  """After the capture at 16 rows, 8-row batches run eagerly then capture
  their own graph, equal to eager steps; 16 rows again warm up anew."""
  loop, state = _pixel_loop("cuda")
  agent, agent_state = loop.agent, state.agent_state
  agent_state, replays = _graph_against_eager(
      agent, agent_state, _batches(loop, state, 3))
  first = agent._train_graph
  assert replays == 2
  agent_state, replays = _graph_against_eager(
      agent, agent_state, _batches(loop, state, 3, size=8))
  assert replays == 2 and agent._train_graph is not first
  _, replays = _graph_against_eager(agent, agent_state,
                                    _batches(loop, state, 2))
  assert replays == 1
