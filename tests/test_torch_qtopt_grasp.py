"""QT-Opt's grasping Q-function in the port (the critic of
`networks/qtopt_networks.py`, CEM's split path of
`policies/cem_policy.py`, `QtOptAgent`'s logit loss and spans, the
`SyntheticGrasp` env, epsilon-greedy's one-hot exploration and
`examples/qtopt_grasping_torch.py`) against the benchmark's plain
reference (`portbench/reference/qtopt.py`) on the CPU, at a small size:
64 x 64 frames and narrow convs in the published pattern. Also the
encoder's max-pools and per-layer paddings, and that a plan without them
computes as before."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from agents_tpu_torch.agents.qtopt import QtOptAgent
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.environments.classic import SyntheticGrasp
from agents_tpu_torch.networks import (EncoderModule, make_critic_network,
                                       make_grasp_q_network)
from agents_tpu_torch.policies import wrappers
from agents_tpu_torch.policies.cem_policy import CEMPolicy
from agents_tpu_torch.policies.cem_samplers import (ConcatenatedSampler,
                                                    GaussianOneHotSampler)
from agents_tpu_torch.specs import array_spec
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.utils import profiling
from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws
from examples import qtopt_grasping_torch as example
from portbench import harness
from portbench.programs import qtopt_grasping
from portbench.reference import common
from portbench.reference import qtopt as ref

torch.set_num_threads(2)

CELL = "qtopt_kalashnikov18.cem64_b32"
SEED = 2**31 + 2512
SMALL = dict(image_size=64, torso_conv_layer_params=((4, 6, 2), (4, 5, 1),
                                                     (4, 5, 1)),
             torso_padding=("VALID", "SAME", "SAME"),
             torso_max_pools=((0, 3, 3), (2, 3, 3)),
             merge_fc_layer_params=(8, 4),
             head_conv_layer_params=((4, 3, 1),) * 3,
             head_max_pools=((1, 2, 2),), head_fc_layer_params=(8,),
             cem_num_samples=8, cem_num_elites=2, env_batch_size=4,
             sample_batch_size=4, replay_capacity=64,
             initial_collect_steps=8, target_update_period=5,
             delayed_target_update_period=2)
HP = {**dataclasses.asdict(example.Config()), **SMALL}
B = 4


def _json(value):
  return [_json(v) for v in value] if isinstance(value, tuple) else value


FIELDS = {k: _json(v) for k, v in SMALL.items()}


def _env(**kwargs):
  return BatchedTorchEnv(SyntheticGrasp(64, **kwargs), B, device="cpu")


def _critic(seed=0):
  env = _env()
  return make_grasp_q_network(
      (env.time_step_spec().observation, env.action_spec()),
      HP["torso_conv_layer_params"], HP["torso_padding"],
      HP["torso_max_pools"], HP["merge_fc_layer_params"],
      HP["head_conv_layer_params"], HP["head_max_pools"],
      HP["head_fc_layer_params"], device="cpu",
      generator=torch.Generator().manual_seed(seed))


def _weights(critic):
  """The reference's leaves, read from the program's parameters."""
  return {k: v.detach().clone()
          for k, v in qtopt_grasping._canonical(HP, critic).items()}


def _observation(seed=1):
  _, time_step = _env().reset(Draws(seed, "cpu"))
  return time_step


def _actions(shape, seed=2):
  g = torch.Generator().manual_seed(seed)
  cont = torch.rand(shape + (5,), generator=g) * 2 - 1
  command = torch.randint(0, 3, shape, generator=g)
  return torch.cat([cont, F.one_hot(command, 3).float()], -1)


def test_the_critic_is_the_references():
  critic = _critic()
  w = _weights(critic)
  time_step = _observation()
  obs = time_step.observation
  action = _actions((B,))
  logits, _ = critic((obs, action), time_step.step_type, ())
  torch.testing.assert_close(logits, ref.logits(w, obs, action, HP,
                                                "float32"),
                             rtol=1e-5, atol=1e-6)
  candidates = _actions((6, B), seed=3)
  features = critic.features(obs)
  assert features.shape == (B,) + critic.map_shape
  got = critic.head(features, candidates, obs)
  want = ref.head(w, ref.torso(w, obs["image"], HP, "float32"), candidates,
                  obs["state"], HP, "float32")
  assert got.shape == (6, B)
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
  # Each candidate scored on the features equals its own full forward.
  for n in range(6):
    one, _ = critic((obs, candidates[n]), time_step.step_type, ())
    torch.testing.assert_close(got[n], one, rtol=1e-6, atol=1e-7)


def _cem_policy(critic, num_iterations=2):
  env = _env()
  return CEMPolicy(env.time_step_spec(), env.action_spec(), critic,
                   num_samples=8, num_elites=2,
                   num_iterations=num_iterations,
                   sampler=ConcatenatedSampler(GaussianOneHotSampler(
                       example.sampler_spec())))


def _elites_of(policy):
  kept = []
  refit = policy.sampler.refit_distribution_to

  def refit_kept(elite_idx, samples):
    kept.append(elite_idx.clone())
    return refit(elite_idx, samples)

  policy.sampler.refit_distribution_to = refit_kept
  return kept


def test_cem_runs_the_torso_once_a_row_and_agrees_with_the_tiled_path():
  critic = _critic()
  time_step = _observation()
  split = _cem_policy(critic)
  split_elites = _elites_of(split)
  draws = RecordingDraws(Draws(7, "cpu"))
  with profiling.record() as rec:
    split_action, split_q = split.optimize(critic, time_step, draws)
  counters = rec.summary()["counters"]
  assert counters == {"cem.candidates": 17 * B, "cem.torso_images": B}
  assert rec.summary()["spans"]["cem.optimize"]["calls"] == 1

  def tiled_critic(inputs, step_type, state):     # no `features`
    return critic(inputs, step_type, state)

  tiled = _cem_policy(critic)
  tiled_elites = _elites_of(tiled)
  with profiling.record() as rec:
    tiled_action, tiled_q = tiled.optimize(
        tiled_critic, time_step, ReplayDraws(draws.records))
  assert rec.summary()["counters"] == {"cem.candidates": 17 * B,
                                       "cem.torso_images": 17 * B}
  assert len(split_elites) == len(tiled_elites) == 2
  for a, b in zip(split_elites, tiled_elites):
    assert torch.equal(a, b)
  assert torch.equal(split_action, tiled_action)
  torch.testing.assert_close(split_q, tiled_q, rtol=0, atol=1e-6)
  one_hot = split_action[:, 5:]
  assert torch.equal(one_hot.sum(-1), torch.ones(B))


def test_the_dense_critic_stays_on_the_tiled_path():
  env = BatchedTorchEnv(SyntheticGrasp(8), B, device="cpu")
  obs_spec = env.time_step_spec().observation["state"]
  critic = make_critic_network(obs_spec, env.action_spec(),
                               joint_fc_layer_params=(8,), device="cpu")
  agent = QtOptAgent(
      ts.time_step_spec(obs_spec), env.action_spec(), critic,
      lambda p: torch.optim.Adam(p, lr=1e-3), cem_num_samples=8,
      cem_num_elites=2, cem_num_iterations=2, device="cpu")
  time_step = ts.restart(torch.rand(B, 2), B)
  with profiling.record() as rec:
    agent.policy.optimize(critic, time_step, Draws(3, "cpu"))
  assert rec.summary()["counters"] == {"cem.candidates": 17 * B,
                                       "cem.torso_images": 17 * B}


def test_the_env_is_the_references_under_fixed_draws():
  env = _env(horizon=5, grasp_radius=2.0)
  draws = RecordingDraws(Draws(11, "cpu"))
  state, time_step = env.reset(draws)
  actions = [_actions((B,), seed=20 + k) for k in range(24)]
  frames = [time_step]
  for action in actions:
    state, time_step = env.step(state, time_step, action, draws)
    frames.append(time_step)
  records = {site: [torch.from_numpy(v) for v in values]
             for site, values in draws.records.items()}
  reference = ref.Env(HP | {"horizon": 5, "grasp_radius": 2.0},
                      common.Recorded(records), B)
  kinds = set()
  for k, action in enumerate(actions):
    obs = reference.obs()
    assert torch.equal(obs["image"], frames[k].observation["image"]), k
    assert torch.equal(obs["state"], frames[k].observation["state"]), k
    reward, discount, step_type = reference.step(action)
    assert torch.equal(reward, frames[k + 1].reward), k
    assert torch.equal(discount, frames[k + 1].discount), k
    assert torch.equal(step_type.to(torch.int32), frames[k + 1].step_type), k
    kinds |= set(step_type.tolist())
    if bool((reward > 0).any()):
      kinds.add("success")
  assert kinds == {0, 1, 2, "success"}


def test_epsilon_greedy_explores_with_one_hot_vectors():
  spec = {"b": array_spec.BoundedArraySpec((2,), np.float32, -1.0, 1.0),
          "a": array_spec.BoundedArraySpec((3,), np.int32, 0, 1)}
  draws = Draws(5, "cpu")
  got = array_spec.map_spec_nest(
      lambda s: wrappers._random_leaf(s, draws, (256,)), spec)
  assert got["a"].dtype == torch.int32
  assert torch.equal(got["a"].sum(-1), torch.ones(256, dtype=torch.int64))
  assert set(got["a"].argmax(-1).tolist()) == {0, 1, 2}
  assert bool((got["b"].abs() <= 1).all())
  policy = wrappers.EpsilonGreedyPolicy(_cem_policy(_critic()), epsilon=1.0)
  time_step = _observation()
  step = policy.action(_critic(), time_step, (), Draws(6, "cpu"))
  assert step.action.shape == (B, 8)
  assert torch.equal(step.action[:, 5:].sum(-1), torch.ones(B))
  assert set(step.action[:, 5:].unique().tolist()) == {0.0, 1.0}


def test_the_example_loop_records_cems_span_and_counters():
  cfg = example.Config(**{**SMALL, "device": "cpu"})
  loop = example.build_loop(cfg)
  state = loop.init(seed=0, initial_collect_steps=8)
  with profiling.record() as rec:
    state, losses = loop.run(state, 2)
  summary = rec.summary()
  assert bool(torch.isfinite(losses).all())
  # Two CEM calls an iteration (collect on B rows, the TD target on S).
  assert summary["spans"]["cem.optimize"]["calls"] == 4
  per_iteration = (2 * 8 + 1) * (B + SMALL["sample_batch_size"])
  assert summary["counters"]["cem.candidates"] == 2 * per_iteration
  assert summary["counters"]["cem.torso_images"] == 2 * (
      B + SMALL["sample_batch_size"])
  assert summary["counters"]["agent.train_steps"] == 2
  assert {"agent.loss", "agent.grad", "agent.apply"} <= set(
      summary["spans"])


def test_a_run_against_the_reference_is_correct():
  run = harness.execute(CELL, SEED, 0.3, False, device="cpu", fields=FIELDS)
  line = harness.result_line(run)
  assert line["correct"] is True, line["checks"]
  numbers = run.numbers
  assert numbers["loss_gap"] < 1e-5 and numbers["td_rms_gap"] < 1e-5
  assert numbers["grad_gap"] < 1e-5 and numbers["update_gap"] < 1e-5
  assert numbers["cem_gap"] < 1e-6
  assert numbers["ring_mismatch"] == numbers["sample_mismatch"] == 0


def shifted_features(loop):
  """CEM scores each row's candidates on the next row's features."""
  loop.agent.policy._features = (
      lambda params, obs: CEMPolicy._features(params, obs).roll(1, 0))


def one_iteration(loop):
  loop.agent.policy.num_iterations = 1


def half_batch(loop):
  """Every train step's loss is the mean over the first half of its
  transitions."""
  original = loop.agent.train

  def train(agent_state, experience, weights=None):
    weights = torch.ones(experience.reward.shape[0])
    weights[weights.shape[0] // 2:] = 0
    return original(agent_state, experience, weights=2 * weights)

  loop.agent.train = train


def unchanged_state(loop):
  loop.agent.optimizer_fn = lambda p: torch.optim.Adam(p, lr=0.0)


@pytest.mark.parametrize("plant,number", [
    (shifted_features, "cem_gap"), (one_iteration, None),
    (half_batch, "loss_gap_first"), (unchanged_state, "update_gap")],
    ids=lambda p: getattr(p, "__name__", p))
def test_a_planted_fault_reads_over_its_limit(plant, number):
  line = harness.run_cell(CELL, SEED, 0.3, False, device="cpu", plant=plant,
                          fields=FIELDS)
  assert line["correct"] is False, line["checks"]
  checks = line["checks"]
  if number is None:   # the reference cannot follow: its draws run out
    assert checks["cem_gap"]["value"] is None
  else:
    assert checks[number]["value"] > checks[number]["limit"]


def _old_conv_stack(encoder, x, plan):
  """The encoder's conv stack as it computed before max-pools."""
  x = x.permute(0, 3, 1, 2)
  for index, stride, pad, padding in plan:
    conv = encoder.convs[index]
    if pad is not None:
      x = F.pad(x, pad)
    x = F.conv2d(x, conv.weight, conv.bias, stride=stride, padding=padding)
    x = encoder.activation(x)
  return x.permute(0, 2, 3, 1)


@pytest.mark.parametrize("frames,padding", [(4, "SAME"), (1, "VALID")],
                         ids=["dqn_same", "r2d2_valid"])
def test_an_encoder_without_pools_computes_as_before(frames, padding):
  spec = array_spec.BoundedArraySpec((84, 84, frames), np.uint8, 0, 255)
  encoder = EncoderModule(spec, ((32, 8, 4), (64, 4, 2), (64, 3, 1)),
                          (16,), preprocessing=lambda x: x.float() / 255.0,
                          device="cpu", padding=padding,
                          generator=torch.Generator().manual_seed(0))
  assert encoder._pools == {}
  assert all(len(step) == 4 for step in encoder._conv_plans[0])
  x = torch.randint(0, 256, (2, 84, 84, frames), dtype=torch.uint8)
  got, _ = encoder(x)
  maps = _old_conv_stack(encoder, x.float() / 255.0, encoder._conv_plans[0])
  want = F.relu(F.linear(maps.reshape(2, -1), encoder.layers[0].weight,
                         encoder.layers[0].bias))
  assert torch.equal(got, want)


def test_pools_take_qtopts_torso_and_head_to_26_and_13():
  spec = array_spec.BoundedArraySpec((472, 472, 3), np.float32, 0.0, 1.0)
  convs = ((2, 6, 2),) + ((2, 5, 1),) * 6
  encoder = EncoderModule(spec, convs, (), device="cpu",
                          padding=("VALID",) + ("SAME",) * 6,
                          max_pools={0: (3, 3), 6: (3, 3)},
                          generator=torch.Generator().manual_seed(0))
  x = torch.rand(1, 472, 472, 3)
  sizes, y = [], x.permute(0, 3, 1, 2)
  for i, conv in enumerate(encoder.convs):
    pad = 0 if i == 0 else 2
    y = F.relu(F.conv2d(y, conv.weight, conv.bias, stride=convs[i][2],
                        padding=pad))
    sizes.append(y.shape[-1])
    if i in (0, 6):
      y = F.max_pool2d(y, 3, 3)
      sizes.append(y.shape[-1])
  assert sizes == [234, 78, 78, 78, 78, 78, 78, 78, 26]
  got = encoder.conv_map(x)
  assert torch.equal(got, y)
  assert encoder.output_size == 26 * 26 * 2
  head = EncoderModule(
      array_spec.ArraySpec((26, 26, 2), np.float32), ((2, 3, 1),) * 9, (),
      device="cpu", max_pools={5: (2, 2)})
  assert head.conv_map(y.permute(0, 2, 3, 1)).shape == (1, 2, 13, 13)
  with pytest.raises(ValueError, match="per conv layer"):
    EncoderModule(spec, convs, (), device="cpu", padding=("SAME",))
