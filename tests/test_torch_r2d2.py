"""R2D2 in the port (`agents/dqn/r2d2_agent.py`, the recurrent dueling Q
network of `networks/lstm_networks.py`, sequence starts of
`replay_buffers/prioritized_replay.py`, the fused loop's priorities and
the encoder's VALID padding) against the benchmark's plain reference
(`portbench/reference/r2d2.py`) on the CPU, at a small size with episode
resets inside the windows."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from agents_tpu_torch.agents.dqn import DqnAgent, R2d2Agent
from agents_tpu_torch.agents.dqn import r2d2_agent
from agents_tpu_torch.networks import (EncoderModule, make_q_network,
                                       make_recurrent_dueling_q_network)
from agents_tpu_torch.networks.encoding_network import same_padding
from agents_tpu_torch.replay_buffers import PrioritizedReplay
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils.common import LossInfo
from agents_tpu_torch.utils.draws import as_draws
from examples import dqn_pixels_torch
from portbench.programs import r2d2_pixels
from portbench.reference import r2d2 as ref

torch.set_num_threads(1)

HP = dict(pixels_size=20, pixels_frames=1, pixels_actions=4,
          conv_layer_params=((4, 4, 2), (8, 3, 1)), fc_layer_params=(16,),
          lstm_size=8, dueling_fc_layer_params=(8,), burn_in=4,
          train_sequence_length=10, n_step_update=2, gamma=0.9,
          value_rescaling_eps=1e-3, priority_eta=0.9)
OBS = array_spec.BoundedArraySpec((20, 20, 1), np.uint8, 0, 255, "pixels")
ACT = array_spec.BoundedArraySpec((), np.int32, 0, 3, "action")
LOOP = dict(dqn_pixels_torch.R2D2, pixels_size=20, pixels_actions=4,
            conv_layer_params=((4, 4, 2), (8, 3, 1)), fc_layer_params=(16,),
            lstm_size=8, dueling_fc_layer_params=(8,), pixels_horizon=12,
            env_batch_size=4, replay_capacity=64, sample_batch_size=4,
            burn_in=4, train_sequence_length=10, n_step_update=2,
            sequence_stride=4, initial_collect_steps=12,
            target_update_period=2, device="cpu")


def _network(seed=0):
  return make_recurrent_dueling_q_network(
      OBS, ACT, conv_layer_params=HP["conv_layer_params"],
      fc_layer_params=HP["fc_layer_params"], lstm_size=HP["lstm_size"],
      dueling_fc_layer_params=HP["dueling_fc_layer_params"],
      preprocessing=lambda x: x.to(torch.float32) / 255.0, device="cpu",
      generator=torch.Generator().manual_seed(seed))


def _weights(net):
  """The reference's leaves, read from the program's parameters."""
  return {k: v.detach().clone()
          for k, v in r2d2_pixels._canonical(HP, net).items()}


def _window(seed=1, batch=3, steps=10):
  """{leaf: [B, T, ...]} windows with FIRST and LAST frames inside, the
  stored carry of their first frame and the previous actions and
  rewards."""
  g = torch.Generator().manual_seed(seed)
  step_type = torch.full((batch, steps), ts.StepType.MID, dtype=torch.int32)
  step_type[0, 3], step_type[0, 4] = ts.StepType.LAST, ts.StepType.FIRST
  step_type[1, 6], step_type[1, 7] = ts.StepType.LAST, ts.StepType.FIRST
  step_type[2, 0] = ts.StepType.FIRST
  step_type[2, 9] = ts.StepType.LAST
  action = torch.randint(0, 4, (batch, steps), generator=g, dtype=torch.int32)
  reward = torch.rand(batch, steps, generator=g) * 4 - 1
  discount = torch.ones(batch, steps)
  discount[:, :-1] = torch.where(step_type[:, 1:] == ts.StepType.LAST, 0.0,
                                 1.0)
  previous_action = torch.roll(action, 1, dims=1)
  previous_reward = torch.roll(reward, 1, dims=1)
  first = step_type == ts.StepType.FIRST
  previous_action = torch.where(first, 0, previous_action)
  previous_reward = torch.where(first, 0.0, previous_reward)
  return {
      "observation": torch.randint(0, 256, (batch, steps, 20, 20, 1),
                                   generator=g, dtype=torch.uint8),
      "step_type": step_type, "action": action, "reward": reward,
      "discount": discount,
      "c": torch.randn(batch, steps, 8, generator=g) * 0.5,
      "h": torch.randn(batch, steps, 8, generator=g) * 0.5,
      "previous_action": previous_action.to(torch.int32),
      "previous_reward": previous_reward}


def _experience(window):
  return tj.Trajectory(
      step_type=window["step_type"], observation=window["observation"],
      action=window["action"],
      policy_info={k: window[k] for k in ("c", "h", "previous_action",
                                          "previous_reward")},
      next_step_type=torch.roll(window["step_type"], -1, dims=1),
      reward=window["reward"], discount=window["discount"])


def _agent(net):
  tss = ts.time_step_spec(OBS)
  return R2d2Agent(tss, ACT, net, lambda p: torch.optim.Adam(p, lr=1e-3),
                   burn_in=HP["burn_in"],
                   train_sequence_length=HP["train_sequence_length"],
                   n_step_update=HP["n_step_update"], gamma=HP["gamma"],
                   target_update_period=2, device="cpu")


def test_network_q_values_and_carry_match_the_reference():
  net = _network()
  w = _weights(net)
  window = _window()
  c0, h0 = window["c"][:, 0], window["h"][:, 0]
  with torch.no_grad():
    q, (c, h) = net(window["observation"], window["step_type"], (c0, h0),
                    previous_action=window["previous_action"],
                    previous_reward=window["previous_reward"])
    q_ref, c_ref, h_ref = ref.unroll(w, window, 0, 10, c0, h0, HP,
                                     "float32")
  assert q.shape == (3, 10, 4) and q.dtype == torch.float32
  torch.testing.assert_close(q, q_ref, atol=1e-6, rtol=1e-5)
  torch.testing.assert_close(c, c_ref, atol=1e-6, rtol=1e-5)
  torch.testing.assert_close(h, h_ref, atol=1e-6, rtol=1e-5)


def test_burn_in_carries_match_the_reference():
  net = _network()
  agent = _agent(net)
  state = agent.init()
  w = _weights(net)
  window = _window(seed=4)
  experience = _experience(window)
  start = (window["c"][:, 0], window["h"][:, 0])
  for network in (state.q_network, state.target_q_network):
    with torch.no_grad():
      _, (c, h) = agent._unroll(network, experience, 0, HP["burn_in"], start)
    _, c_ref, h_ref = ref.unroll(w, window, 0, HP["burn_in"], *start, HP,
                                 "float32")
    torch.testing.assert_close(c, c_ref, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(h, h_ref, atol=1e-6, rtol=1e-5)


def test_loss_td_errors_priorities_and_gradients_match_the_reference():
  net = _network()
  agent = _agent(net)
  state = agent.init()
  with torch.no_grad():     # a target unlike the online network
    for p in state.target_q_network.parameters():
      p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                .manual_seed(p.numel())))
  online = {k: v.detach().clone().requires_grad_(True)
            for k, v in _weights(net).items()}
  target = _weights(state.target_q_network)
  window = _window(seed=7)
  weights = torch.tensor([1.0, 0.5, 0.25])
  loss, extra = agent._loss(state.q_network, state, _experience(window),
                            weights)
  loss_ref, delta_ref, count = ref.sequence_loss(online, target, window,
                                                 weights, HP, "float32")
  torch.testing.assert_close(loss, loss_ref, atol=1e-6, rtol=1e-5)
  trained = HP["train_sequence_length"] - HP["burn_in"]
  assert extra.td_error.shape == (3, trained)
  torch.testing.assert_close(extra.td_error[:, :delta_ref.shape[1]],
                             delta_ref, atol=1e-5, rtol=1e-5)
  assert not extra.td_error[:, delta_ref.shape[1]:].any()
  torch.testing.assert_close(extra.priority,
                             ref.priorities_of(delta_ref, count, HP),
                             atol=1e-5, rtol=1e-5)
  params = dict(r2d2_pixels._canonical(HP, state.q_network))
  grads = torch.autograd.grad(loss, list(params.values()))
  grads_ref = torch.autograd.grad(loss_ref, list(online.values()))
  ref_by_name = dict(zip(online, grads_ref))
  for (name, _), g in zip(params.items(), grads):
    torch.testing.assert_close(g, ref_by_name[name], atol=1e-6, rtol=1e-4,
                               msg=name)
  # Row 1's frame 6 (trained position 2) is LAST: no trained position.
  assert extra.td_error[1, 2] == 0 and extra.td_error[1, :2].abs().min() > 0


@pytest.mark.parametrize("low,high", [(-1e4, 1e4), (-1e-3, 1e-3)])
def test_inverse_value_rescaling_undoes_it(low, high):
  x = torch.linspace(low, high, 20001)
  eps = 1e-3
  back = r2d2_agent.inverse_value_rescale(r2d2_agent.value_rescale(x, eps),
                                          eps)
  torch.testing.assert_close(back, x, atol=1e-5, rtol=2e-6)
  # The stable form against the closed form in float64.
  h = r2d2_agent.value_rescale(x.double(), eps)
  torch.testing.assert_close(r2d2_agent.inverse_value_rescale(h, eps),
                             ref.unrescale(h, eps).double(), atol=1e-6,
                             rtol=1e-6)


def _loop(**fields):
  cfg = dqn_pixels_torch.Config(**{**LOOP, **fields})
  return dqn_pixels_torch.build_loop(cfg)


def test_the_ring_stores_each_frames_carry():
  loop = _loop()
  state = loop.init(seed=3, initial_collect_steps=30)
  storage, count = state.replay_state.storage, state.replay_state.count
  net = loop.agent.q_network
  batch = loop.env.batch_size
  c = torch.zeros(batch, 8)
  h = torch.zeros(batch, 8)
  previous_action = torch.zeros(batch, dtype=torch.int32)
  previous_reward = torch.zeros(batch)
  assert (storage.step_type[:count] == ts.StepType.FIRST).any(dim=1)[1:].any()
  for t in range(count):
    first = storage.step_type[t] == ts.StepType.FIRST
    c, h = torch.where(first[:, None], 0.0, c), torch.where(first[:, None],
                                                            0.0, h)
    previous_action = torch.where(first, 0, previous_action)
    info = storage.policy_info
    torch.testing.assert_close(info["c"][t], c, atol=1e-6, rtol=0)
    torch.testing.assert_close(info["h"][t], h, atol=1e-6, rtol=0)
    assert torch.equal(info["previous_action"][t], previous_action)
    assert torch.equal(info["previous_reward"][t], previous_reward)
    with torch.no_grad():
      _, (c, h) = net(storage.observation[t], storage.step_type[t], (c, h),
                      previous_action=previous_action,
                      previous_reward=previous_reward)
    previous_action = storage.action[t]
    previous_reward = storage.reward[t]


@pytest.mark.parametrize("capacity", [64, 30])
def test_only_stride_aligned_starts_are_sampled(capacity):
  spec = {"x": array_spec.ArraySpec((), np.int64)}
  replay = PrioritizedReplay(spec, batch_size=3, max_length=capacity,
                             alpha=0.9, sequence_stride=4, device="cpu")
  state = replay.init()
  draws = as_draws(0, "cpu")
  n = 6
  for t in range(75):
    state = replay.add_batch(state, {"x": torch.full((3,), t)})
    if state.count < n:
      continue
    batch, info = replay.sample(state, draws, 16, num_steps=n, beta=0.6)
    assert torch.equal(batch["x"][:, 0], info.ids)
    assert (info.ids % capacity % 4 == 0).all()
    assert (info.ids >= state.count - min(state.count, capacity)).all()
    assert (info.ids <= state.count - n).all()
    assert (info.is_weights > 0).all() and info.is_weights.max() == 1
    state = replay.update_priorities(state, info,
                                     torch.rand(16, generator=torch.Generator()
                                                .manual_seed(t)) * 5)
  off_stride = torch.arange(capacity) % 4 != 0
  assert not state.priorities[off_stride].any()


def test_update_priorities_takes_the_agents_priority():
  loop = _loop()
  state = loop.init(seed=5, initial_collect_steps=12)
  replay_state = state.replay_state
  _, info = loop._sample(replay_state, state.draws)
  sample = loop.sample_batch_size
  td = torch.arange(sample * 6, dtype=torch.float32).reshape(sample, 6) - 7
  priority = torch.linspace(0.5, 2.0, sample)
  expected = loop.replay.update_priorities(
      dataclasses.replace(replay_state,
                          priorities=replay_state.priorities.clone()),
      info, priority).priorities
  extra = r2d2_agent.R2d2LossExtra(td_loss=td**2, td_error=td,
                                   priority=priority)
  got = loop._update_priorities(
      dataclasses.replace(replay_state,
                          priorities=replay_state.priorities.clone()),
      info, LossInfo(loss=torch.zeros(()), extra=extra)).priorities
  assert torch.equal(got, expected)
  # A sequence loss with no priority of its own: the mean of |td|.
  mean = loop.replay.update_priorities(
      dataclasses.replace(replay_state,
                          priorities=replay_state.priorities.clone()),
      info, td.abs().mean(dim=1)).priorities
  from agents_tpu_torch.agents.dqn import DqnLossExtra
  got = loop._update_priorities(
      dataclasses.replace(replay_state,
                          priorities=replay_state.priorities.clone()),
      info, LossInfo(loss=torch.zeros(()),
                     extra=DqnLossExtra(td_loss=td**2, td_error=td))
  ).priorities
  assert torch.equal(got, mean)
  assert not torch.equal(mean, expected)


def test_build_loop_runs_r2d2_with_its_target_update():
  loop = _loop()
  assert isinstance(loop.agent, R2d2Agent)
  assert isinstance(loop.replay, PrioritizedReplay)
  assert loop.replay.sequence_stride == 4 and loop.per_beta == 0.6
  state = loop.init(seed=7, initial_collect_steps=12)
  q, target = state.agent_state.q_network, state.agent_state.target_q_network
  pairs = list(zip(q.parameters(), target.parameters()))
  steps = []
  for _ in range(3):
    state, losses = loop.run(state, 1)
    assert torch.isfinite(losses).all()
    steps.append(all(torch.equal(a, b) for a, b in pairs))
  # Period 2: the target takes the online weights after step 2 only.
  assert steps == [False, True, False]
  assert state.agent_state.train_step == 3


def test_the_r2d2_train_step_is_never_a_cuda_graph():
  tss = ts.time_step_spec(OBS)

  def graphable(agent):
    state = agent.init()
    for group in state.optimizer.param_groups:
      group["capturable"] = True
    agent.device = torch.device("cuda")   # no allocation: a flag test
    return agent._graphable(state)

  assert not graphable(_agent(_network()))
  dqn = DqnAgent(tss, ACT, make_q_network(OBS, ACT, fc_layer_params=(8,),
                                          device="cpu"),
                 lambda p: torch.optim.Adam(p), device="cpu")
  assert graphable(dqn)


def _conv_chain(encoder, x, pads):
  """The convolutions with each layer's (F.pad widths or None, conv
  padding)."""
  x = x.permute(0, 3, 1, 2)
  for conv, (pad, padding) in zip(encoder.convs, pads):
    if pad is not None:
      x = F.pad(x, pad)
    x = F.relu(F.conv2d(x, conv.weight, conv.bias, stride=conv.stride,
                        padding=padding))
  return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def test_valid_padding_is_unpadded_and_same_stays_as_before():
  spec = array_spec.ArraySpec((84, 84, 1), np.float32)
  convs = dqn_pixels_torch.MNIH15
  x = torch.rand(2, 84, 84, 1, generator=torch.Generator().manual_seed(0))
  valid = EncoderModule(spec, convs, (), padding="VALID", device="cpu")
  assert valid.output_size == 3136
  out, _ = valid(x)
  assert torch.equal(out, _conv_chain(valid, x, [(None, 0)] * 3))
  same = EncoderModule(spec, convs, (), device="cpu")
  assert same.output_size == 11 * 11 * 64
  # SAME as the encoder has always padded: an even split inside the
  # convolution, else F.pad with the odd pixel at the end.
  pads, size = [], 84
  for _, kernel, stride in convs:
    lo, hi = same_padding(size, kernel, stride)
    pads.append((None, (lo, lo)) if lo == hi else ((lo, hi, lo, hi), 0))
    size = -(-size // stride)
  out, _ = same(x)
  assert torch.equal(out, _conv_chain(same, x, pads))
  with pytest.raises(ValueError):
    EncoderModule(spec, convs, (), padding="same", device="cpu")
