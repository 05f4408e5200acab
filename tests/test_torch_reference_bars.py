"""The JAX package's own runs that set the port's learning bars, and checks
that they run the port's configurations.

`chip_smoke.py`'s `td3_learn` and `bc` phases hold the port to bars set by
the JAX package at the same configuration on the CPU, not by the port:

  td3     `agents_tpu`'s `Td3Agent` in its `FusedTrainLoop` at
          `examples/td3_pendulum_torch.py --preset=live` (B=8, ring 8192,
          sample 256, 4 train steps, (64, 64), Fujimoto et al.'s TD3
          settings), checked every 250 iterations up to 8,000: the first
          iteration whose last-20 return reaches -250.
  offline the pipeline of `examples/cql_sac_offline_torch.py` (the device
          Pendulum pipeline of `tests/test_cql_offline_e2e.py`): a brief
          SAC behaviour run, a 2,048 x 8 frame collect by
          ``GaussianPolicy(GreedyPolicy(...), 0.1)``, an npz round trip
          through `dataset_io`, then `BehavioralCloningAgent` on the SAC
          actor for `offline_train_steps` steps (greedy return over exactly
          30 episodes, and its D4RL normalized score against the
          behaviour policy's greedy return and random play, each over 30
          episodes) and `CqlSacAgent` with 1,000 BC steps (greedy return
          after the BC steps and at the end).

Run them (about 10 minutes on 8 CPU cores), over seeds 0-4 for TD3 and
phase-C seeds 0-3 for the offline agents:

    JAX_PLATFORMS=cpu python tests/test_torch_reference_bars.py [td3]
        [offline]

The tests below check that these runs are built from the port examples'
configurations, so the bars are of the same configuration.
"""
import dataclasses
import json
import math
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LEARN_CHUNK, LEARN_GATE = 250, -250.0


def _adam(lr):
  import optax
  return optax.adam(lr)


def jax_td3_loop(cfg):
  """The JAX `FusedTrainLoop` of a TD3 (or DDPG) example config."""
  from agents_tpu import metrics, networks
  from agents_tpu.agents.ddpg import DdpgAgent
  from agents_tpu.agents.td3 import Td3Agent
  from agents_tpu.environments.classic.pendulum import Pendulum
  from agents_tpu.environments.jax_environment import BatchedJaxEnv
  from agents_tpu.replay_buffers import UniformReplay
  from agents_tpu.train import FusedTrainLoop
  from agents_tpu.trajectories import trajectory as tj

  env = BatchedJaxEnv(Pendulum(cfg.max_episode_steps),
                      batch_size=cfg.env_batch_size)
  tss, asp = env.time_step_spec(), env.action_spec()
  actor = networks.make_deterministic_actor_network(
      tss.observation, asp, fc_layer_params=cfg.actor_fc_layers)
  critic = networks.make_critic_network(
      tss.observation, asp, joint_fc_layer_params=cfg.critic_joint_fc_layers)
  common = dict(target_update_tau=cfg.target_update_tau,
                target_update_period=cfg.target_update_period,
                gamma=cfg.gamma, reward_scale_factor=cfg.reward_scale_factor)
  if cfg.agent == "td3":
    agent = Td3Agent(tss, asp, actor, critic, _adam(cfg.actor_lr),
                     _adam(cfg.critic_lr),
                     exploration_noise_std=cfg.exploration_noise_std,
                     actor_update_period=cfg.actor_update_period,
                     target_policy_noise=cfg.target_policy_noise,
                     target_policy_noise_clip=cfg.target_policy_noise_clip,
                     **common)
  else:
    agent = DdpgAgent(tss, asp, actor, critic, _adam(cfg.actor_lr),
                      _adam(cfg.critic_lr), ou_stddev=cfg.ou_stddev,
                      ou_damping=cfg.ou_damping,
                      dqda_clipping=cfg.dqda_clipping or None, **common)
  replay = UniformReplay(tj.trajectory_spec(tss, asp), cfg.env_batch_size,
                         cfg.replay_capacity)
  return FusedTrainLoop(env, agent, replay,
                        metrics=metrics.standard_collect_metrics(
                            cfg.return_buffer),
                        sample_batch_size=cfg.sample_batch_size,
                        train_steps_per_iteration=cfg.train_steps_per_iteration)


def run_td3_bar(cfg):
  """Iterations until the last-20 return reaches -250 (checked every 250),
  and the return then; greedy eval over 30 episodes."""
  import jax
  import numpy as np

  loop = jax_td3_loop(cfg)
  state = jax.jit(lambda k: loop.init(
      k, initial_collect_steps=cfg.initial_collect_steps))(
          jax.random.key(cfg.seed))
  run = jax.jit(lambda s: loop.run(s, LEARN_CHUNK))
  points, iterations, ret = [], 0, -math.inf
  t0 = time.time()
  while iterations < cfg.num_iterations:
    state, _ = run(state)
    iterations += LEARN_CHUNK
    ret = float(np.asarray(loop.results(state)["AverageReturn"]))
    points.append([iterations, ret])
    print(f"td3 {iterations}: {ret:.2f}", flush=True)
    if ret >= LEARN_GATE:
      break
  out = loop.evaluate(state, jax.random.key(cfg.seed + 101), num_episodes=30,
                      max_steps=2000)
  return {"passed_at": iterations if ret >= LEARN_GATE else None,
          "last20_average_return": ret, "points": points,
          "eval_episodes": int(out["NumberOfEpisodes"]),
          "eval_average_return": float(out["AverageReturn"]),
          "seconds": time.time() - t0}


def normalized_score(ret, behavior_return, random_return):
  """D4RL's normalized score: 0 at random play, 1 at the behaviour
  policy (both greedy returns over the same episodes)."""
  return (ret - random_return) / (behavior_return - random_return)


def _sac_kwargs(cfg, tss, asp):
  """`_sac_kwargs` of `tests/test_cql_offline_e2e.py` at `cfg`'s widths."""
  from agents_tpu import networks
  return dict(
      critic_network=networks.make_critic_network(
          tss.observation, asp,
          joint_fc_layer_params=cfg.critic_joint_fc_layers),
      actor_network=networks.make_sac_actor_network(
          tss.observation, asp, fc_layer_params=cfg.actor_fc_layers),
      actor_optimizer=_adam(cfg.actor_lr),
      critic_optimizer=_adam(cfg.critic_lr),
      alpha_optimizer=_adam(cfg.alpha_lr),
      target_update_tau=cfg.target_update_tau, gamma=cfg.gamma,
      reward_scale_factor=cfg.reward_scale_factor)


def run_offline_bars(cfg, seeds=(0,)):
  """Phases A-C of the offline pipeline with the JAX package: one dataset
  (phases A and B from `cfg.seed`), then for each phase-C seed s BC's and
  CQL's greedy returns (30 and 10 episodes), their networks drawn from
  ``key(s + 2)`` and their samples from ``key(s + 3)``."""
  import jax
  import numpy as np

  from agents_tpu import metrics, networks
  from agents_tpu.agents.behavioral_cloning import BehavioralCloningAgent
  from agents_tpu.agents.cql import CqlSacAgent
  from agents_tpu.agents.sac import SacAgent
  from agents_tpu.drivers.jax_driver import JaxDriver
  from agents_tpu.environments.classic.pendulum import Pendulum
  from agents_tpu.environments.jax_environment import BatchedJaxEnv
  from agents_tpu.eval import metric_utils
  from agents_tpu.policies.random_policy import RandomPolicy
  from agents_tpu.policies.wrappers import GaussianPolicy, GreedyPolicy
  from agents_tpu.replay_buffers import UniformReplay
  from agents_tpu.train import FusedTrainLoop
  from agents_tpu.trajectories import trajectory as tj
  from agents_tpu.utils import dataset_io

  t0 = time.time()
  b = cfg.env_batch_size
  env = BatchedJaxEnv(Pendulum(cfg.max_episode_steps), batch_size=b)
  tss, asp = env.time_step_spec(), env.action_spec()
  data_spec = tj.trajectory_spec(tss, asp)

  # Phase A: the behaviour policy.
  behavior = SacAgent(tss, asp, **_sac_kwargs(cfg, tss, asp))
  replay = UniformReplay(data_spec, b, cfg.behavior_replay_capacity)
  loop = FusedTrainLoop(env, behavior, replay,
                        metrics=metrics.standard_collect_metrics(20),
                        sample_batch_size=cfg.behavior_sample_batch_size,
                        train_steps_per_iteration=cfg.behavior_train_steps)
  state = jax.jit(lambda k: loop.init(
      k, initial_collect_steps=cfg.behavior_initial_collect_steps))(
          jax.random.key(cfg.seed))
  run = jax.jit(lambda s: loop.run(s, cfg.behavior_chunk))
  iterations = 0
  while iterations < cfg.behavior_iterations:
    state, _ = run(state)
    iterations += cfg.behavior_chunk
    if float(np.asarray(loop.results(state)["AverageReturn"])) > \
        cfg.behavior_gate:
      break

  def greedy_eval(agent, params, episodes):
    out = metric_utils.evaluate_jax_env_episodes(
        env, agent.policy, params, jax.random.key(7),
        num_episodes=episodes, max_steps=2000)
    return float(out["AverageReturn"])

  behavior_params = behavior.policy_params(state.agent_state)
  behavior_return = greedy_eval(behavior, behavior_params, 10)
  behavior_return_30 = greedy_eval(behavior, behavior_params, 30)
  random_return = float(metric_utils.evaluate_jax_env_episodes(
      env, RandomPolicy(tss, asp), (), jax.random.key(7), num_episodes=30,
      max_steps=2000)["AverageReturn"])

  # Phase B: the dataset, written through the observer and read back.
  frames = cfg.dataset_frames
  data_policy = GaussianPolicy(GreedyPolicy(behavior.policy),
                               scale=cfg.dataset_noise)
  data_replay = UniformReplay(data_spec, b, frames)
  realized = metrics.AverageReturnMetric(100)
  driver = JaxDriver(env, data_policy,
                     observers=[data_replay.add_batch, realized.update])

  @jax.jit
  def collect(params, k):
    k_init, k_run = jax.random.split(k)
    _, (rs, ms) = driver.run(params, driver.init(k_init),
                             (data_replay.init(), realized.init(b)), k_run,
                             num_steps=frames)
    return rs, realized.result(ms)

  data_rstate, dataset_return = collect(behavior_params,
                                        jax.random.key(cfg.seed + 11))
  all_frames = jax.device_get(data_replay.gather_all(data_rstate))
  template = jax.tree_util.tree_map(
      lambda s: np.zeros((1,) + tuple(s.shape), s.dtype), data_spec)
  with tempfile.TemporaryDirectory() as tmp:
    observer = dataset_io.TrajectoryFileObserver(
        tmp, data_spec, frames_per_shard=cfg.frames_per_shard)
    for t in range(frames):
      observer(jax.tree_util.tree_map(lambda x: x[:, t], all_frames))
    observer.flush()
    offline_replay = UniformReplay(data_spec, b,
                                   dataset_io.dataset_num_frames(tmp))
    rstate = dataset_io.dataset_to_replay(tmp, template, offline_replay,
                                          offline_replay.init())

  def train_steps(agent, agent_state, key, n, num_steps):
    @jax.jit
    def chunk(ag, k):
      def one(a, kk):
        exp, _ = offline_replay.sample(rstate, kk, cfg.offline_batch_size,
                                       num_steps=num_steps)
        a, loss = agent.train(a, exp)
        return a, loss.loss
      return jax.lax.scan(one, ag, jax.random.split(k, 100))

    for _ in range(n // 100):
      key, k = jax.random.split(key)
      agent_state, losses = chunk(agent_state, k)
    return agent_state, float(np.asarray(losses[-1])), key

  # Phase C: behavioural cloning, then CQL-SAC, on the same dataset.
  out = {"behavior_iterations": iterations, "behavior_return": behavior_return,
         "behavior_return_30": behavior_return_30,
         "random_return_30": random_return,
         "dataset_policy_return": float(np.asarray(dataset_return)),
         "dataset_frames": int(np.asarray(rstate.count)), "phase_c": {}}
  for seed in seeds:
    bc = BehavioralCloningAgent(
        tss, asp, networks.make_sac_actor_network(
            tss.observation, asp, fc_layer_params=cfg.actor_fc_layers),
        _adam(cfg.actor_lr))
    bc_state, bc_loss, _ = train_steps(
        bc, bc.init(jax.random.key(seed + 2)), jax.random.key(seed + 3),
        cfg.offline_train_steps, None)
    cql = CqlSacAgent(tss, asp, cql_alpha=cfg.cql_alpha,
                      num_cql_samples=cfg.num_cql_samples,
                      num_bc_steps=cfg.num_bc_steps,
                      softmax_temperature=cfg.softmax_temperature,
                      initial_log_alpha=math.log(cfg.initial_alpha),
                      **_sac_kwargs(cfg, tss, asp))
    cql_state, key = cql.init(jax.random.key(seed + 2)), jax.random.key(
        seed + 3)
    cql_state, _, key = train_steps(cql, cql_state, key, cfg.num_bc_steps, 2)
    cql_bc_return = greedy_eval(cql, cql.policy_params(cql_state), 10)
    cql_state, cql_loss, _ = train_steps(
        cql, cql_state, key, cfg.offline_train_steps - cfg.num_bc_steps, 2)
    bc_return = greedy_eval(bc, bc.policy_params(bc_state), 30)
    out["phase_c"][seed] = {
        "bc_loss": bc_loss, "bc_eval_episodes": 30,
        "bc_eval_average_return": bc_return,
        "bc_normalized_score": normalized_score(bc_return, behavior_return_30,
                                                random_return),
        "cql_return_after_bc_steps": cql_bc_return,
        "cql_offline_return": greedy_eval(cql, cql.policy_params(cql_state),
                                          10),
        "cql_loss": cql_loss}
    print(json.dumps({"phase_c_seed": seed, **out["phase_c"][seed]}),
          flush=True)
  out["seconds"] = time.time() - t0
  return out


# -- the runs are of the port examples' configurations ------------------------


def test_td3_bar_runs_the_live_preset_and_ddpg_builds():
  """The JAX loop built from the port's `--preset=live` config is TD3 at
  that config (widths, replay, train steps, TD3 settings); the DDPG config
  builds the OU collect policy."""
  from agents_tpu.policies.wrappers import GaussianPolicy, OUNoisePolicy
  from examples.td3_pendulum_torch import parse_td3_args

  cfg = parse_td3_args(["--preset=live"])
  loop = jax_td3_loop(cfg)
  agent = loop.agent
  assert (loop.env.batch_size, loop.replay.capacity, loop.sample_batch_size,
          loop.train_steps) == (8, 8192, 256, 4)
  assert cfg.num_iterations == 8000 and cfg.initial_collect_steps == 128
  assert (agent.actor_update_period, agent.target_policy_noise,
          agent.target_policy_noise_clip, agent.target_update_tau,
          agent.gamma, agent.reward_scale_factor) == (2, 0.2, 0.5, 0.005,
                                                      0.99, 1.0)
  assert isinstance(agent.collect_policy, GaussianPolicy)
  assert agent.collect_policy.scale == 0.1
  ddpg = jax_td3_loop(parse_td3_args(["--preset=live", "--agent=ddpg"]))
  assert isinstance(ddpg.agent.collect_policy, OUNoisePolicy)
  assert (ddpg.agent.collect_policy.ou_damping,
          ddpg.agent.collect_policy.ou_stddev) == (0.15, 0.2)


def test_offline_bars_run_the_example_defaults():
  """The offline pipeline's config is `tests/test_cql_offline_e2e.py`'s:
  B=8, (64, 64), ring 4096 and 2 train steps of 128 for the behaviour run,
  2,048 frames at noise 0.1 in shards of 512, CQL at alpha 10, 8 samples,
  1,000 BC steps, temperature 50 and initial alpha 0.1 over 3,000 steps of
  256."""
  from examples.cql_sac_offline_torch import Config

  cfg = Config()
  assert (cfg.env_batch_size, cfg.actor_fc_layers, cfg.critic_joint_fc_layers,
          cfg.behavior_replay_capacity, cfg.behavior_train_steps,
          cfg.behavior_sample_batch_size,
          cfg.behavior_initial_collect_steps) == (8, (64, 64), (64, 64), 4096,
                                                  2, 128, 128)
  assert (cfg.dataset_frames, cfg.dataset_noise, cfg.frames_per_shard) == (
      2048, 0.1, 512)
  assert (cfg.cql_alpha, cfg.num_cql_samples, cfg.num_bc_steps,
          cfg.softmax_temperature, cfg.initial_alpha,
          cfg.offline_train_steps, cfg.offline_batch_size) == (
              10.0, 8, 1000, 50.0, 0.1, 3000, 256)
  assert (cfg.reward_scale_factor, cfg.target_update_tau) == (1.0, 0.005)


if __name__ == "__main__":
  from examples.cql_sac_offline_torch import Config as OfflineConfig
  from examples.td3_pendulum_torch import parse_td3_args

  which = sys.argv[1:] or ["td3", "offline"]
  if "td3" in which:
    for seed in range(5):
      td3 = run_td3_bar(dataclasses.replace(parse_td3_args(["--preset=live"]),
                                            seed=seed))
      print(json.dumps({"td3_live_seed": seed, **{
          k: v for k, v in td3.items() if k != "points"}}), flush=True)
  if "offline" in which:
    offline = run_offline_bars(OfflineConfig(), seeds=range(4))
    print(json.dumps({"offline": offline}), flush=True)
