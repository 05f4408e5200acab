"""Checkpointer / PolicySaver / Learner / Actor / triggers of the port, the
DQN example through its `Learner`, the eval job and the distributed jobs'
exports.

Twins of ``tests/test_train_orchestration.py``, plus the port's Learner
against the JAX package's: over 20 fused DQN iterations, one `run(1)` at
a time, the loss sequences agree (rtol 1e-5 / atol 1e-6) from the same
params and the JAX loop's draws replayed at their sites.
"""
import json
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from agents_tpu.train import Learner as JaxLearner
from agents_tpu_torch import metrics
from agents_tpu_torch.agents.dqn import DqnAgent
from agents_tpu_torch.environments import BatchedTorchEnv
from agents_tpu_torch.environments.classic import CartPole
from agents_tpu_torch.environments.test_envs import (CountingPyEnv,
                                                     RandomPyEnvironment)
from agents_tpu_torch.networks import make_q_network
from agents_tpu_torch.policies import policy_saver as ps_lib
from agents_tpu_torch.replay_buffers import UniformReplay
from agents_tpu_torch.train import (Actor, Checkpointer, FusedTrainLoop,
                                    IntervalTrigger, JsonlSummaryWriter,
                                    Learner, StepPerSecondLogTrigger,
                                    collect_metrics)
from agents_tpu_torch.train.train_utils import (get_specs_from_env,
                                                wait_for_file,
                                                wait_for_policy,
                                                wait_for_predicate)
from agents_tpu_torch.trajectories import policy_step
from agents_tpu_torch.trajectories import time_step as ts
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import common, convert
from agents_tpu_torch.utils.draws import ReplayDraws
from examples import dqn_cartpole_torch, eval_job_torch
from test_torch_fused_loop import B, CAP, INITIAL, S, _jax_loop, _torch_loop
from test_torch_parity_utils import (assert_close, jax_collect_draws,
                                     jax_reset_draws, jax_sample_draws,
                                     merge_draws)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_loop(b=4, hist=False):
  env = BatchedTorchEnv(CartPole(), b, device="cpu")
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = make_q_network(tss.observation, asp, fc_layer_params=(16,),
                        device="cpu")
  agent = DqnAgent(tss, asp, qnet, lambda p: torch.optim.Adam(p, lr=1e-3),
                   gamma=0.99,
                   td_errors_loss_fn=common.element_wise_squared_loss,
                   device="cpu")
  replay = UniformReplay(tj.trajectory_spec(tss, asp), b, 256, device="cpu")
  ms = metrics.standard_collect_metrics(8)
  if hist:
    ms += (metrics.ChosenActionHistogram(num_actions=2),)
  return FusedTrainLoop(env, agent, replay, metrics=ms, sample_batch_size=16,
                        device="cpu"), agent


def _records(path):
  with open(path) as f:
    return [json.loads(line) for line in f]


def test_checkpointer_roundtrip(tmp_path):
  ckpt = Checkpointer(str(tmp_path / "ck"), max_to_keep=2)
  state = {"w": torch.arange(4.0), "step": 3}
  ckpt.save(3, state, force=True)
  ckpt.wait()
  template = {"w": torch.zeros(4), "step": 0}
  restored = ckpt.restore(template)
  assert restored["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
  assert restored["step"] == 3
  # initialize_or_restore on an empty directory returns the template.
  out = Checkpointer(str(tmp_path / "empty")).initialize_or_restore(
      {"w": torch.zeros(4), "step": 0})
  assert out["step"] == 0


def test_policy_saver_roundtrip(tmp_path):
  loop, agent = _make_loop()
  params = agent.policy_params(agent.init())
  saver = ps_lib.PolicySaver(agent.policy, train_step=7,
                             metadata={"env": "CartPole"})
  export = str(tmp_path / "greedy_policy")
  saver.save(export, params)
  loaded = ps_lib.load_policy(export, agent.policy, device="cpu")
  assert loaded.get_train_step() == 7
  assert loaded.get_metadata()["env"] == "CartPole"
  obs = np.random.RandomState(0).randn(5, 4).astype(np.float32)
  step = ts.TimeStep(step_type=np.zeros((5,), np.int32),
                     reward=np.zeros((5,), np.float32),
                     discount=np.ones((5,), np.float32), observation=obs)
  astep = loaded.action(step)
  assert set(astep.action.tolist()) <= {0, 1}
  # The loaded params are a copy: the actions equal the in-memory policy's.
  with torch.no_grad():
    direct = agent.policy.action(params, ts.TimeStep(
        *(torch.as_tensor(x) for x in (step.step_type, step.reward,
                                       step.discount, obs))))
  np.testing.assert_array_equal(astep.action, direct.action.numpy())
  assert loaded.params is not params


def test_learner_run_and_restore(tmp_path):
  loop, _ = _make_loop()
  state = loop.init(0, initial_collect_steps=20)
  learner = Learner(str(tmp_path), loop=loop, initial_state=state,
                    checkpoint_interval=5)
  loss = learner.run(iterations=5)
  assert np.isfinite(loss)
  assert learner.global_step == 5
  assert Checkpointer(str(tmp_path / "train" / "checkpoints")).all_steps() \
      == [5]
  learner.checkpoint()

  # A new learner restores at step 5.
  loop2, _ = _make_loop()
  learner2 = Learner(str(tmp_path), loop=loop2,
                     initial_state=loop2.init(1, initial_collect_steps=20),
                     checkpoint_interval=5)
  assert learner2.global_step == 5
  for k, v in learner.state.agent_state.q_network.state_dict().items():
    assert torch.equal(learner2.state.agent_state.q_network.state_dict()[k],
                       v)


def test_interval_trigger():
  fired = []
  trig = IntervalTrigger(10, lambda: fired.append(1))
  trig(3)
  assert not fired
  trig(10)
  assert len(fired) == 1
  trig(19)
  assert len(fired) == 1
  trig(20)
  assert len(fired) == 2
  logs = []
  step = [0]
  sps = StepPerSecondLogTrigger(lambda: step[0], 5, log_fn=logs.append)
  step[0] = 5
  sps(5)
  assert len(logs) == 1 and logs[0].startswith("step 5:")


def test_actor_with_host_env():
  class GoRight:
    def action(self, time_step, state=()):
      return policy_step.PolicyStep(action=np.asarray(0, np.int32),
                                    state=state)

    def init_state(self, batch_size=None):
      return ()

  actor = Actor(CountingPyEnv(steps_per_episode=3), GoRight(),
                steps_per_run=9, metrics=collect_metrics(5), name="collect")
  actor.run()
  results = actor.log_metrics()
  assert results["AverageReturn"] == 3.0
  assert results["EnvironmentSteps"] == 9


def test_learner_summary_observability(tmp_path):
  """loss, loss extras, collect metrics and steps/s under the summary
  gate."""
  loop, _ = _make_loop()
  state = loop.init(0, initial_collect_steps=8)
  path = str(tmp_path / "summaries.jsonl")
  learner = Learner(str(tmp_path), loop=loop, initial_state=state,
                    checkpoint_interval=0,
                    summary_writer=JsonlSummaryWriter(path),
                    summary_interval=2,
                    extra_summary_fn=lambda s: {"staleness": 0.0})
  for _ in range(4):
    learner.run(1)
  keys = {k for rec in _records(path) for k in rec if k not in ("step", "t")}
  assert {"loss", "loss_extra/td_loss", "loss_extra/td_error",
          "collect/EnvironmentSteps", "collect/NumberOfEpisodes",
          "collect/AverageReturn", "steps_per_sec", "staleness"} <= keys
  assert sorted({r["step"] for r in _records(path)}) == [2, 4]


def test_learner_routes_action_histogram_to_writer(tmp_path):
  loop, _ = _make_loop(hist=True)
  state = loop.init(0, initial_collect_steps=8)
  path = str(tmp_path / "summaries.jsonl")
  learner = Learner(str(tmp_path), loop=loop, initial_state=state,
                    checkpoint_interval=0,
                    summary_writer=JsonlSummaryWriter(path),
                    summary_interval=1)
  learner.run(2)
  hist = [r["collect/ChosenActionHistogram"] for r in _records(path)
          if "collect/ChosenActionHistogram" in r]
  assert hist and len(hist[-1]) == 2 and sum(hist[-1]) > 0


LEARNER_ITERS = 20


def _jax_loop_draws(key, asp, iterations):
  """Every draw of the JAX loop's `init(key, INITIAL)` and `iterations`
  iterations, per site (as ``test_torch_fused_loop._jax_loop_draws``)."""
  _, k_driver, k_collect, k_loop = jax.random.split(key, 4)
  records = [{"env_reset": [jax_reset_draws(k_driver, B)]},
             jax_collect_draws(k_collect, INITIAL, B, asp)]
  k = k_loop
  for i in range(iterations):
    k, k_c, k_s = jax.random.split(k, 3)
    num_valid = min(INITIAL + i + 1, CAP) - 2 + 1
    records.append(jax_collect_draws(k_c, 1, B, asp))
    records.append(jax_sample_draws(jax.random.split(k_s, 1)[0], S,
                                    num_valid, B))
  return merge_draws(*records)


def test_learner_losses_match_the_jax_learner(tmp_path):
  """20 fused DQN iterations, one `Learner.run(1)` at a time, on both
  packages: the same 20 losses, and the same train step."""
  jloop = _jax_loop()
  key = jax.random.key(7)
  jstate = jax.jit(lambda k: jloop.init(k, initial_collect_steps=INITIAL))(
      key)
  q0 = jax.device_get(jstate.agent_state.q_params)
  jlearner = JaxLearner(str(tmp_path / "jax"), loop=jloop,
                        initial_state=jstate, checkpoint_interval=0)
  jlosses = [jlearner.run(1) for _ in range(LEARNER_ITERS)]

  tloop = _torch_loop(q0)
  draws = ReplayDraws(_jax_loop_draws(key, jloop.env.action_spec(),
                                      LEARNER_ITERS))
  tstate = tloop.init(draws=draws, initial_collect_steps=INITIAL)
  # A ReplayDraws is not checkpointed (it replays another run's draws).
  learner = Learner(str(tmp_path / "port"), loop=tloop, initial_state=tstate,
                    checkpoint_interval=0)
  losses = [learner.run(1) for _ in range(LEARNER_ITERS)]
  assert all(v == 0 for v in draws.remaining().values())
  assert_close(np.asarray(losses), np.asarray(jlosses))
  assert learner.global_step == jlearner.global_step == LEARNER_ITERS
  assert learner.state.agent_state.train_step == LEARNER_ITERS
  expect = convert.q_params_to_state_dict(
      jax.device_get(jlearner.state.agent_state.q_params))
  for k, v in learner.state.agent_state.q_network.state_dict().items():
    assert_close(v, expect[k], err_msg=k)


def _small_cfg(root, **fields):
  return dqn_cartpole_torch.Config(
      root_dir=str(root), env_batch_size=4, num_iterations=40,
      initial_collect_steps=8, replay_capacity=32, sample_batch_size=8,
      fc_layer_params=(8,), log_interval=10, checkpoint_interval=20,
      num_eval_episodes=2, device="cpu", **fields)


def test_example_killed_after_a_checkpoint_resumes_from_it(tmp_path):
  """The example through its Learner: a run killed between checkpoints
  (at 30, after the one at 20) resumes at 20 and ends where an unbroken
  run ends, bit for bit; train.jsonl keeps its keys."""
  whole = tmp_path / "whole"
  dqn_cartpole_torch.train_eval(_small_cfg(whole))
  whole_ckpt = torch.load(whole / "train" / "checkpoints" / "40.pt",
                          weights_only=True)

  broken = tmp_path / "broken"

  def dies_at_30(cfg):
    loop = dqn_cartpole_torch.build_loop(cfg)
    run, calls = loop.run_with_info, [0]

    def run_with_info(state, n):
      calls[0] += 1
      if calls[0] == 3:
        raise KeyboardInterrupt("killed")
      return run(state, n)

    loop.run_with_info = run_with_info
    return loop

  with pytest.raises(KeyboardInterrupt):
    dqn_cartpole_torch.train_eval(_small_cfg(broken), build=dies_at_30)
  assert Checkpointer(str(broken / "train" / "checkpoints")).all_steps() \
      == [20]
  dqn_cartpole_torch.train_eval(_small_cfg(broken))
  broken_ckpt = torch.load(broken / "train" / "checkpoints" / "40.pt",
                           weights_only=True)

  def equal(a, b):
    if isinstance(a, torch.Tensor):
      return torch.equal(a, b)
    if isinstance(a, dict):
      return set(a) == set(b) and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
      return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    return a == b

  assert equal(broken_ckpt, whole_ckpt)
  records = _records(broken / "train.jsonl")
  steps = [r["step"] for r in records if "loss" in r]
  assert steps == [10, 20, 30, 40]   # 30 again after the resume
  keys = {k for r in records for k in r}
  assert {"loss", "AverageReturn", "steps_per_sec", "EvalAverageReturn",
          "loss_extra/td_loss", "collect/AverageReturn"} <= keys


def test_example_exports_the_policy_trio(tmp_path):
  cfg = _small_cfg(tmp_path, seed=3, policy_interval=20)
  dqn_cartpole_torch.train_eval(cfg)
  for name in ("greedy_policy", "collect_policy", "policy"):
    manifest = ps_lib.load_manifest(str(tmp_path / "policies" / name))
    assert manifest["train_step"] == 40, name
  loaded = ps_lib.load_policy(str(tmp_path / "policies" / "greedy_policy"),
                              device="cpu")
  assert loaded.get_train_step() == 40
  parsed = dqn_cartpole_torch.parse_args(
      ["--device=cpu", "--cfg.policy_interval=7", "--smoke"],
      dqn_cartpole_torch.Config())
  assert parsed.policy_interval == 7 and parsed.device == "cpu"
  assert dqn_cartpole_torch.Config().policy_interval == 0


def _cartpole_export(root, train_step=5, seed=0):
  env = BatchedTorchEnv(CartPole(), 2, device="cpu")
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = make_q_network(tss.observation, asp, fc_layer_params=(8,),
                        device="cpu",
                        generator=torch.Generator().manual_seed(seed))
  agent = DqnAgent(tss, asp, qnet, torch.optim.Adam, device="cpu")
  saver = ps_lib.PolicySaver(agent.policy, train_step=train_step)
  directory = os.path.join(root, "policies", "greedy_policy")
  saver.save(directory, qnet)
  return saver, directory, qnet


def test_eval_job_reloads_on_a_newer_train_step(tmp_path):
  """The eval job rebuilds the greedy policy from its manifest, evaluates
  it on a host env (random envs with CartPole's specs), and evaluates
  again when a params-only refresh raises the train step."""
  saver, directory, qnet = _cartpole_export(str(tmp_path))
  cartpole = CartPole()
  lines = []
  args = eval_job_torch.parse_args([
      f"--root_dir={tmp_path}", "--eval_episodes=3", "--poll_secs=0.05",
      "--max_evals=2", "--device=cpu"])
  job = threading.Thread(target=eval_job_torch.run_eval_job, args=(
      args, lambda: RandomPyEnvironment(cartpole.observation_spec(),
                                        cartpole.action_spec(),
                                        max_duration=10),
      lines.append))
  job.start()
  assert wait_for_predicate(lambda: len(lines) >= 2, 0.05, 120)
  with torch.no_grad():
    for p in qnet.parameters():
      p.mul_(-1.0)
  saver.train_step = 9
  saver.save_checkpoint(directory, qnet)
  job.join(timeout=120)
  evals = [json.loads(l) for l in lines if "train_step" in l]
  assert [e["train_step"] for e in evals] == [5, 9]
  for e in evals:
    assert 1.0 <= e["AverageEpisodeLength"] <= 10.0


def test_eval_job_command_line_on_gymnasium_cartpole(tmp_path):
  _cartpole_export(str(tmp_path), train_step=11)
  out = subprocess.run(
      [sys.executable, os.path.join(ROOT, "examples", "eval_job_torch.py"),
       f"--root_dir={tmp_path}", "--env_name=CartPole-v1",
       "--eval_episodes=2", "--max_evals=1", "--poll_secs=0.1",
       "--device=cpu"],
      capture_output=True, text=True, timeout=300, cwd=ROOT)
  assert out.returncode == 0, out.stderr[-2000:]
  last = json.loads(out.stdout.strip().splitlines()[-1])
  assert last["train_step"] == 11 and last["AverageEpisodeLength"] > 0


def test_sac_train_job_writes_exports(tmp_path):
  """The learner exports the collect and greedy policies at its first
  publish (whole artifacts) and refreshes their params and train step
  after."""
  from examples import sac_train_job_torch
  env = RandomPyEnvironment(
      ps_lib.array_spec.ArraySpec((3,), np.float32),
      ps_lib.array_spec.BoundedArraySpec((1,), np.float32, -2.0, 2.0))
  args = sac_train_job_torch.parse_args([
      f"--root_dir={tmp_path}", f"--rings=t_exp_{os.getpid()}",
      "--device=cpu", "--ring_capacity=64", "--replay_rows=4",
      "--replay_max_length=8"])
  learner = sac_train_job_torch.Learner(args, env.time_step_spec(),
                                        env.action_spec())
  try:
    learner.publish()
    collect = str(tmp_path / "policies" / "collect_policy")
    greedy = str(tmp_path / "policies" / "greedy_policy")
    for d in (collect, greedy):
      assert ps_lib.load_manifest(d)["train_step"] == 0
      assert ps_lib.load_manifest(d)["policy_config"] is not None
    program = os.path.join(collect, "exported_action_cpu.pt2")
    mtime = os.stat(program).st_mtime_ns
    learner.train_steps = 200
    learner.publish()
    assert ps_lib.load_manifest(collect)["train_step"] == 200
    assert ps_lib.load_manifest(greedy)["train_step"] == 200
    assert os.stat(program).st_mtime_ns == mtime
    assert learner.seconds["export"] > 0
  finally:
    learner.close()


def test_collector_without_shm_picks_up_an_export(tmp_path):
  """A collect job without `--weights_shm` polls the learner's collect
  export, loads its params, and acts with them."""
  from agents_tpu_torch.replay_buffers.host_ingest import IngestServer
  from agents_tpu_torch.specs import array_spec
  from examples import sac_collect_job_torch

  obs = array_spec.ArraySpec((3,), np.float32)
  act = array_spec.BoundedArraySpec((1,), np.float32, -2.0, 2.0)
  env = RandomPyEnvironment(obs, act)
  tss, asp = env.time_step_spec(), env.action_spec()
  agent = sac_collect_job_torch.build_agent(tss, asp, seed=5, device="cpu")
  actor = agent.collect_policy_params(agent.init())
  directory = str(tmp_path / "policies" / "collect_policy")
  ps_lib.PolicySaver(agent.collect_policy, train_step=5).save(directory,
                                                              actor)
  args = sac_collect_job_torch.parse_args([
      f"--root_dir={tmp_path}", f"--ring=t_exp_c_{os.getpid()}",
      "--env_batch_size=2", "--total_ticks=4", "--random_ticks=0",
      "--policy_poll_ticks=1"])
  spec = array_spec.add_outer_dims_nest(tj.trajectory_spec(tss, asp), (2,))
  server = IngestServer(args.ring, spec, capacity=64)
  try:
    done = sac_collect_job_torch.run_collector(
        args, make_env=lambda _: RandomPyEnvironment(obs, act),
        log=lambda line: None)
  finally:
    server.close()
  assert done["policy_train_step"] == 5
  assert done["pulls"] == [
      [5, sac_collect_job_torch.snapshot_crc32(actor.state_dict())]]
  assert done["pushed_items"] == 3 * 2


def test_wait_helpers(tmp_path):
  target = tmp_path / "flag.txt"

  def writer():
    time.sleep(0.2)
    target.write_text("ok")

  threading.Thread(target=writer).start()
  found = wait_for_file(str(tmp_path / "*.txt"), 0.05, 5.0)
  assert found and found.endswith("flag.txt")
  assert wait_for_predicate(lambda: True, timeout_secs=1)
  assert not wait_for_predicate(lambda: False, 0.01, 0.05)
  assert wait_for_policy(str(tmp_path / "none"), 0.01, 0.05) is None
  obs_spec, act_spec, tss = get_specs_from_env(CountingPyEnv())
  assert tss.observation == obs_spec and act_spec.num_values == 2
