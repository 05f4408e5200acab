"""The host-device slice: `HostDeviceTrainLoop` (SAC) and
`HostOnPolicyTrainLoop` (PPO) of the PyTorch port against the JAX
package's, over gymnasium envs on the host; `PyDriver`, `compute` and the
py metrics; a JAX `DeviceState` carried across by `convert`.

Both sides start from the same networks (the JAX side's flax init carried
across) and the same seeded gymnasium envs, and take the same draws: the
random collect's `RandomState`, and every device draw re-derived from the
JAX loop's own key chain (``host_device_loop.py:65-117``: ``split(key)``
for the action, ``split`` again for the sample, ``split(k_sample, K)``
per train step; ``fold_in(key(17), step)`` for SAC's normals; per env
step ``split(key)`` for the PPO policy's Gumbel uniforms and one more for
the epochs' permutations, ``host_on_policy_loop.py:44-67``) and replayed
into the port. The env steps take each side's own actions, so the
observations agree to the tolerance of the actions. SAC's state, losses
and replay agree to rtol 1e-5 / atol 1e-5 (the Adam second moments to
atol 1e-9), PPO's to rtol 1e-5 / atol 1e-6 (the Adam second moments, sums
of squared gradients over 8 minibatch steps of float32 rounding, to rtol
1e-4 / atol 1e-9); step types, discrete actions and py-metric results
exactly or to those tolerances.
"""
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from agents_tpu import networks as jnetworks
from agents_tpu.agents.ppo import PPOAgent as JaxPPOAgent
from agents_tpu.agents.sac import SacAgent as JaxSacAgent
from agents_tpu.drivers.py_driver import PyDriver as JaxPyDriver
from agents_tpu.environments import suite_gym as jsuite_gym
from agents_tpu.environments.batched_py_environment import \
    BatchedPyEnvironment as JaxBatchedPyEnvironment
from agents_tpu.environments.test_envs import CountingPyEnv as JaxCounting
from agents_tpu.eval import metric_utils as jmetric_utils
from agents_tpu.metrics import py_metrics as jpy_metrics
from agents_tpu.policies.jitted_py_policy import \
    JittedPyPolicy as JaxJittedPyPolicy
from agents_tpu.replay_buffers import UniformReplay as JaxUniformReplay
from agents_tpu.train import HostDeviceTrainLoop as JaxHostDeviceTrainLoop
from agents_tpu.train import HostOnPolicyTrainLoop as JaxHostOnPolicyLoop
from agents_tpu.trajectories import policy_step as jps
from agents_tpu.trajectories import trajectory as jtj
from agents_tpu_torch.agents.ppo import PPOAgent
from agents_tpu_torch.agents.sac import SacAgent
from agents_tpu_torch.drivers import PyDriver
from agents_tpu_torch.environments import suite_gym
from agents_tpu_torch.environments.batched_py_environment import \
    BatchedPyEnvironment
from agents_tpu_torch.environments.test_envs import CountingPyEnv
from agents_tpu_torch.eval import metric_utils
from agents_tpu_torch.metrics import py_metrics
from agents_tpu_torch.networks import (make_actor_distribution_network,
                                       make_critic_network,
                                       make_sac_actor_network,
                                       make_value_network)
from agents_tpu_torch.policies.jitted_py_policy import JittedPyPolicy
from agents_tpu_torch.replay_buffers import UniformReplay
from agents_tpu_torch.train import (HostDeviceTrainLoop,
                                    HostOnPolicyTrainLoop)
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.trajectories import trajectory as tj
from agents_tpu_torch.utils import convert, nest_utils
from agents_tpu_torch.utils.draws import ReplayDraws
from test_torch_parity_utils import (POLICY_DRAWS, assert_close,
                                     assert_equal, jax_sac_train_draws,
                                     jax_sample_draws, merge_draws)
from test_torch_ppo_agent import jax_permutations
from test_torch_sac_agent import assert_sac_states_close

torch.set_num_threads(1)

SAC_RTOL = SAC_ATOL = 1e-5
PPO_RTOL, PPO_ATOL, PPO_NU_RTOL, NU_ATOL = 1e-5, 1e-6, 1e-4, 1e-9
B, S, K, CAP, FC = 2, 16, 2, 64, (16,)
RANDOM_TICKS, POLICY_TICKS, RUN_TICKS, MORE_TICKS = 4, 2, 3, 2
ENV_SEED, COLLECT_SEED = 100, 3
FIELDS = ("step_type", "observation", "action", "next_step_type", "reward",
          "discount")


def _py_metrics(lib):
  return [lib.AverageReturnMetric(5), lib.AverageEpisodeLengthMetric(5),
          lib.EnvironmentSteps(), lib.NumberOfEpisodes()]


def _pendulums(load, batched):
  env = batched([load("Pendulum-v1") for _ in range(B)])
  env.seed(ENV_SEED)
  return env


def _jax_sac_loop():
  env = _pendulums(jsuite_gym.load, JaxBatchedPyEnvironment)
  tss, asp = env.time_step_spec(), env.action_spec()
  agent = JaxSacAgent(
      tss, asp,
      critic_network=jnetworks.make_critic_network(
          tss.observation, asp, joint_fc_layer_params=FC),
      actor_network=jnetworks.make_sac_actor_network(
          tss.observation, asp, fc_layer_params=FC),
      actor_optimizer=optax.adam(3e-4), critic_optimizer=optax.adam(3e-4),
      alpha_optimizer=optax.adam(3e-4))
  replay = JaxUniformReplay(jtj.trajectory_spec(tss, asp), B, CAP)
  return JaxHostDeviceTrainLoop(env, agent, replay, train_steps_per_tick=K,
                                sample_batch_size=S,
                                py_metrics=_py_metrics(jpy_metrics))


def _torch_sac_loop():
  env = _pendulums(suite_gym.load, BatchedPyEnvironment)
  tss, asp = env.time_step_spec(), env.action_spec()
  adam = lambda p: torch.optim.Adam(p, lr=3e-4)  # noqa: E731
  agent = SacAgent(
      tss, asp,
      make_critic_network(tss.observation, asp, joint_fc_layer_params=FC,
                          device="cpu"),
      make_sac_actor_network(tss.observation, asp, fc_layer_params=FC,
                             device="cpu"),
      adam, adam, adam, device="cpu")
  replay = UniformReplay(tj.trajectory_spec(tss, asp), B, CAP, device="cpu")
  return HostDeviceTrainLoop(env, agent, replay, train_steps_per_tick=K,
                             sample_batch_size=S,
                             py_metrics=_py_metrics(py_metrics), device="cpu")


def _load_networks(agent, jagent_state):
  for net, params, fn in (
      (agent.actor_network, jagent_state.actor_params,
       convert.sac_actor_params_to_state_dict),
      (agent.critic_network, jagent_state.critic1_params,
       convert.sac_critic_params_to_state_dict),
      (agent.critic_network_2, jagent_state.critic2_params,
       convert.sac_critic_params_to_state_dict)):
    net.load_state_dict(fn(params))


def _policy_tick_draws(key, asp):
  """The draws of one `_device_collect_only` tick: ``key, k_act =
  split(key)``, the actor's normals from `k_act`."""
  key, k_act = jax.random.split(key)
  return key, POLICY_DRAWS["actor"](k_act, B, asp)


def _run_tick_draws(key, asp, count, train_step):
  """The draws of one `_device_step` tick whose insert makes the replay
  count `count`; its train steps start at `train_step`."""
  key, records = _policy_tick_draws(key, asp)
  records = [records]
  key, k_sample = jax.random.split(key)
  num_valid = min(count, CAP) - 2 + 1
  for j, k in enumerate(jax.random.split(k_sample, K)):
    records.append(jax_sample_draws(k, S, num_valid, B))
    records.append(jax_sac_train_draws(train_step + j, S, asp))
  return key, merge_draws(*records)


def _host_loop_draws(key, asp, policy_ticks, run_ticks, count, train_step):
  records = []
  for _ in range(policy_ticks):
    key, rec = _policy_tick_draws(key, asp)
    records.append(rec)
    count += 1
  count -= 1 if policy_ticks else 0     # the first collect tick inserts none
  for i in range(run_ticks):
    key, rec = _run_tick_draws(key, asp, count + i + 1, train_step + i * K)
    records.append(rec)
  return merge_draws(*records)


def _torch_time_step(jstep):
  from agents_tpu_torch.trajectories import time_step as ts
  return ts.TimeStep(step_type=jstep.step_type, reward=jstep.reward,
                     discount=jstep.discount, observation=jstep.observation)


@pytest.fixture(scope="module")
def sac_runs():
  jloop = _jax_sac_loop()
  jdev, jt = jloop.init(0)
  _, asp = jloop.env.time_step_spec(), jloop.env.action_spec()
  jdev, jt, jpt, jpa = jloop.collect(jdev, jt, RANDOM_TICKS, seed=COLLECT_SEED)
  key_after_random = jdev.key
  jdev, jt, jpt, jpa = jloop.collect(jdev, jt, POLICY_TICKS, random=False)
  jdev, jt, jpt, jpa, jloss = jloop.run(jdev, jt, jpt, jpa, RUN_TICKS)

  tloop = _torch_sac_loop()
  _load_networks(tloop.agent, jax.device_get(jloop.agent.init(
      jax.random.key(0))))
  draws = ReplayDraws(_host_loop_draws(
      key_after_random, asp, POLICY_TICKS, RUN_TICKS, RANDOM_TICKS - 1, 0))
  tdev, tt = tloop.init(draws=draws)
  tdev = dataclasses.replace(tdev, agent_state=dataclasses.replace(
      tdev.agent_state, draws=draws))
  tdev, tt, tpt, tpa = tloop.collect(tdev, tt, RANDOM_TICKS,
                                     seed=COLLECT_SEED)
  tdev, tt, tpt, tpa = tloop.collect(tdev, tt, POLICY_TICKS, random=False)
  tdev, tt, tpt, tpa, tloss = tloop.run(tdev, tt, tpt, tpa, RUN_TICKS)
  return ((jloop, jdev, (jt, jpt, jpa), jloss),
          (tloop, tdev, (tt, tpt, tpa), tloss), draws)


def _assert_replays_close(tstate, jstate, msg=""):
  assert tstate.count == int(jstate.count)
  for f in FIELDS:
    a, b = getattr(tstate.storage, f), getattr(jstate.storage, f)
    if a.dtype.is_floating_point:
      assert_close(a, b, SAC_RTOL, SAC_ATOL, f"{msg} {f}")
    else:
      assert_equal(a, b, f"{msg} {f}")


def _assert_host_close(t_nests, j_nests):
  for tn, jn in zip(t_nests, j_nests):
    for a, b in zip(nest_utils.flatten_sorted(tn),
                    jax.tree_util.tree_leaves(jn)):
      assert np.asarray(a).dtype == np.asarray(b).dtype
      assert_close(a, b, SAC_RTOL, SAC_ATOL)


def test_sac_host_loop_matches_jax(sac_runs):
  (jloop, jdev, jhost, jloss), (tloop, tdev, thost, tloss), draws = sac_runs
  assert all(v == 0 for v in draws.remaining().values())
  assert np.isfinite(tloss)
  assert_close(tloss, jloss, SAC_RTOL, SAC_ATOL, "loss")
  assert_sac_states_close(jdev.agent_state, tdev.agent_state, "host loop",
                          SAC_RTOL, SAC_ATOL)
  assert tdev.agent_state.train_step == RUN_TICKS * K
  # 3 random inserts, 1 policy-collect insert, 3 run inserts.
  assert tdev.replay_state.count == RANDOM_TICKS - 1 + POLICY_TICKS - 1 + \
      RUN_TICKS
  _assert_replays_close(tdev.replay_state, jdev.replay_state)
  _assert_host_close(thost, jhost)
  jres, tres = jloop.metric_results(), tloop.metric_results()
  assert set(jres) == set(tres)
  for k in jres:
    assert_close(tres[k], jres[k], SAC_RTOL, SAC_ATOL, k)
  steps = RANDOM_TICKS + POLICY_TICKS + RUN_TICKS
  assert tres["EnvironmentSteps"] == steps * B
  assert set(tloop.split) == {"device_call_s", "action_read_s", "env_step_s"}


def test_random_collect_actions_equal_jax_bit_for_bit(sac_runs):
  """The random ticks' actions come from the same `RandomState` calls:
  the replay's first frames hold equal actions."""
  (_, jdev, _, _), (_, tdev, _, _), _ = sac_runs
  n = RANDOM_TICKS - 1
  assert_equal(tdev.replay_state.storage.action[:n],
               jdev.replay_state.storage.action[:n])


def test_carried_device_state_continues_as_jax(sac_runs):
  """The JAX `DeviceState` (agent and replay) carried into a fresh port
  loop over the port's env: both loops continue `MORE_TICKS` ticks as
  one."""
  (jloop, jdev, (jt, jpt, jpa), _), (tloop, _, (tt, tpt, tpa), _), _ = \
      sac_runs
  asp = jloop.env.action_spec()
  key = jdev.key
  jdev2, _, _, jpa2, jloss = jloop.run(jdev, jt, jpt, jpa, MORE_TICKS)

  fresh = _torch_sac_loop()
  draws = ReplayDraws(_host_loop_draws(key, asp, 0, MORE_TICKS,
                                       int(jdev.replay_state.count),
                                       RUN_TICKS * K))
  dev, _ = fresh.init(draws=draws)
  # `init` resets its own env; the run goes on in the port's first env.
  fresh.env.close()
  fresh.env = tloop.env
  jhost = jax.device_get(jdev)
  agent_state = convert.load_sac_agent_state(
      dev.agent_state, convert.sac_agent_state_to_torch(jhost.agent_state))
  dev = dataclasses.replace(
      dev, agent_state=dataclasses.replace(agent_state, draws=draws),
      replay_state=convert.load_uniform_replay_state(
          dev.replay_state,
          convert.uniform_replay_state_to_torch(jhost.replay_state)))
  # The port's host time steps equal the JAX loop's to the actions'
  # tolerance; continue from them.
  dev, _, _, tpa2, tloss = fresh.run(dev, tt, tpt, tpa, MORE_TICKS)
  assert all(v == 0 for v in draws.remaining().values())
  assert_close(tloss, jloss, SAC_RTOL, SAC_ATOL, "loss")
  assert_sac_states_close(jdev2.agent_state, dev.agent_state, "carried",
                          SAC_RTOL, SAC_ATOL)
  _assert_replays_close(dev.replay_state, jdev2.replay_state, "carried")
  assert_close(tpa2, jpa2, SAC_RTOL, SAC_ATOL, "actions")


# -- host PPO ------------------------------------------------------------------

PPO_B, PPO_T, EPOCHS, MINIBATCHES, PPO_ITERS = 4, 16, 2, 2, 2


def _cartpoles(load, batched):
  env = batched([load("CartPole-v1") for _ in range(PPO_B)])
  env.seed(ENV_SEED)
  return env


def _ppo_loops():
  jenv = _cartpoles(jsuite_gym.load, JaxBatchedPyEnvironment)
  tss, asp = jenv.time_step_spec(), jenv.action_spec()
  kw = dict(num_epochs=EPOCHS, num_minibatches=MINIBATCHES)
  jagent = JaxPPOAgent(
      tss, asp, optax.adam(3e-3),
      jnetworks.make_actor_distribution_network(tss.observation, asp,
                                                fc_layer_params=(16,)),
      jnetworks.make_value_network(tss.observation, fc_layer_params=(16,)),
      **kw)
  jloop = JaxHostOnPolicyLoop(jenv, jagent, rollout_length=PPO_T,
                              py_metrics=_py_metrics(jpy_metrics))
  tenv = _cartpoles(suite_gym.load, BatchedPyEnvironment)
  tss, asp = tenv.time_step_spec(), tenv.action_spec()
  tagent = PPOAgent(
      tss, asp, lambda p: torch.optim.Adam(p, lr=3e-3),
      make_actor_distribution_network(tss.observation, asp,
                                      fc_layer_params=(16,), device="cpu"),
      make_value_network(tss.observation, fc_layer_params=(16,),
                         device="cpu"), device="cpu", **kw)
  tloop = HostOnPolicyTrainLoop(tenv, tagent, rollout_length=PPO_T,
                                py_metrics=_py_metrics(py_metrics),
                                device="cpu")
  return jloop, tloop


def _ppo_iteration_draws(key, asp):
  """`run_iteration(..., key)`'s draws: per step ``key, sub = split(key)``
  and the policy's Gumbel uniforms from `sub`; then the permutations."""
  records = []
  for _ in range(PPO_T):
    key, sub = jax.random.split(key)
    records.append(POLICY_DRAWS["ppo"](sub, PPO_B, asp))
  key, sub = jax.random.split(key)
  records.append(jax_permutations(sub, EPOCHS, PPO_B * (PPO_T - 1)))
  return key, merge_draws(*records)


@pytest.fixture(scope="module")
def ppo_runs():
  jloop, tloop = _ppo_loops()
  asp = jloop.env.action_spec()
  jstate, jt = jloop.init(0)
  params0 = jax.device_get(jstate)
  tloop.agent.actor_network.load_state_dict(
      convert.actor_params_to_state_dict(params0.actor_params))
  tloop.agent.value_network.load_state_dict(
      convert.value_params_to_state_dict(params0.value_params))
  tstate, tt = tloop.init(0)
  texps = []
  collect = tloop.collect

  def recording_collect(*args):
    out = collect(*args)
    texps.append(out[1])
    return out

  tloop.collect = recording_collect
  key, jinfos, tinfos = jax.random.key(1), [], []
  for _ in range(PPO_ITERS):
    _, rec = _ppo_iteration_draws(key, asp)
    jstate, jt, key, jinfo = jloop.run_iteration(jstate, jt, key)
    draws = ReplayDraws(rec)
    tstate, tt, _, tinfo = tloop.run_iteration(tstate, tt, draws)
    assert all(v == 0 for v in draws.remaining().values())
    jinfos.append(jinfo)
    tinfos.append(tinfo)
  return (jloop, jstate, jt, jinfos), (tloop, tstate, tt, tinfos), texps


def test_host_ppo_iterations_match_jax(ppo_runs):
  (jloop, jstate, jt, jinfos), (tloop, tstate, tt, tinfos), _ = ppo_runs
  for j, t in zip(jinfos, tinfos):
    assert_close(t.loss, j.loss, PPO_RTOL, PPO_ATOL, "loss")
  expect = convert.ppo_agent_state_to_torch(jax.device_get(jstate))
  for field in ("actor_network", "value_network"):
    for k, v in getattr(tstate, field).state_dict().items():
      assert_close(v, expect[field][k], PPO_RTOL, PPO_ATOL, f"{field}.{k}")
  params = [p for g in tstate.optimizer.param_groups for p in g["params"]]
  assert len(params) == len(expect["adam"])
  for i, p in enumerate(params):
    st, ex = tstate.optimizer.state[p], expect["adam"][i]
    assert float(st["step"]) == float(ex["step"]) == PPO_ITERS * EPOCHS * \
        MINIBATCHES
    assert_close(st["exp_avg"], ex["exp_avg"], PPO_RTOL, PPO_ATOL, f"mu {i}")
    assert_close(st["exp_avg_sq"], ex["exp_avg_sq"], PPO_NU_RTOL, NU_ATOL,
                 f"nu {i}")
  for field in ("obs_norm_state", "reward_norm_state"):
    if expect[field] == ():
      continue
    for name in ("count", "mean_sum", "var_sum"):
      assert_close(getattr(getattr(tstate, field), name),
                   getattr(expect[field], name), PPO_RTOL, PPO_ATOL, name)
  assert tstate.train_step == expect["train_step"] == PPO_ITERS
  for a, b in zip(nest_utils.flatten_sorted(tt),
                  jax.tree_util.tree_leaves(jt)):
    assert_close(a, b, PPO_RTOL, PPO_ATOL)
  jres, tres = jloop.metric_results(), tloop.metric_results()
  for k in jres:
    assert_close(tres[k], jres[k], PPO_RTOL, PPO_ATOL, k)
  assert tres["EnvironmentSteps"] >= PPO_ITERS * PPO_T * PPO_B - \
      tres["NumberOfEpisodes"]


def test_host_ppo_experience_is_batch_major_on_the_device(ppo_runs):
  """The rollout is [B, T] with the collect-time distribution and value
  predictions; its step types chain, boundary frames included."""
  _, (tloop, _, _, _), texps = ppo_runs
  exp = texps[0]
  assert tuple(exp.step_type.shape) == (PPO_B, PPO_T)
  assert tuple(exp.observation.shape) == (PPO_B, PPO_T, 4)
  assert tuple(exp.policy_info["dist"].logits.shape) == (PPO_B, PPO_T, 2)
  assert tuple(exp.policy_info["value_prediction"].shape) == (PPO_B, PPO_T)
  assert bool((exp.next_step_type[:, :-1] == exp.step_type[:, 1:]).all())
  assert set(tloop.split) == {"collect_s", "stack_copy_s"}


# -- PyDriver, compute, JittedPyPolicy ---------------------------------------

class _GoRight:
  def __init__(self, psl):
    self.psl = psl

  def action(self, time_step, state=()):
    return self.psl.PolicyStep(action=np.asarray(0, np.int32), state=state)


@pytest.mark.parametrize("kw", [dict(max_steps=12), dict(max_episodes=3),
                                dict(max_episodes=3,
                                     end_episode_on_boundary=False)])
def test_py_driver_counts_as_jax(kw):
  results = []
  for env, lib, driver_cls, psl in (
      (CountingPyEnv(3), py_metrics, PyDriver, ps),
      (JaxCounting(3), jpy_metrics, JaxPyDriver, jps)):
    metrics = _py_metrics(lib)
    transitions = []
    driver = driver_cls(env, _GoRight(psl), observers=metrics,
                        transition_observers=[transitions.append], **kw)
    final, _ = driver.run(env.reset())
    results.append(([m.result() for m in metrics], len(transitions),
                     int(final.observation)))
  assert results[0] == results[1]
  if "max_steps" in kw:
    assert results[0][0] == [3.0, 3.0, 12, 4]


def test_compute_with_jitted_py_policy_matches_jax(sac_runs):
  """Greedy eval through `JittedPyPolicy` and `compute` on 2 seeded
  Pendulums: the same episodes' returns on both sides."""
  (jloop, jdev, _, _), (tloop, tdev, _, _), _ = sac_runs
  jenv = _pendulums(jsuite_gym.load, JaxBatchedPyEnvironment)
  tenv = _pendulums(suite_gym.load, BatchedPyEnvironment)
  jpolicy = JaxJittedPyPolicy(jloop.agent.policy,
                              jloop.agent.policy_params(jdev.agent_state))
  tpolicy = JittedPyPolicy(tloop.agent.policy, device="cpu")
  tpolicy.update_params(tloop.agent.policy_params(tdev.agent_state))
  jout = jmetric_utils.compute([jpy_metrics.AverageReturnMetric(4)], jenv,
                               jpolicy, num_episodes=2)
  tout = metric_utils.compute([py_metrics.AverageReturnMetric(4)], tenv,
                              tpolicy, num_episodes=2)
  assert_close(tout["AverageReturn"], jout["AverageReturn"], 1e-4, 1e-3)
  assert tout["AverageReturn"] < 0.0
  tenv.close()
  jenv.close()


def test_jitted_py_policy_batches_an_unbatched_env():
  env = suite_gym.load("Pendulum-v1")
  tss, asp = env.time_step_spec(), env.action_spec()
  actor = make_sac_actor_network(tss.observation, asp, fc_layer_params=(8,),
                                 device="cpu")
  from agents_tpu_torch.policies import ActorPolicy
  policy = JittedPyPolicy(ActorPolicy(tss, asp, actor), actor,
                          batch_time_steps=True, device="cpu")
  step = policy.action(env.reset())
  assert isinstance(step.action, np.ndarray)
  assert step.action.shape == (1,) and step.action.dtype == np.float32
  assert np.all(np.abs(step.action) <= 2.0)
  env.close()
