"""The JAX package's own runs that set the port's learning bars, and checks
that they run the port's configurations.

`chip_smoke.py`'s `td3_learn`, `qtopt_learn` and `bc` phases hold the port
to bars set by the JAX package at the same configuration on the CPU, not
by the port:

  td3     `agents_tpu`'s `Td3Agent` in its `FusedTrainLoop` at
          `examples/td3_pendulum_torch.py --preset=live` (B=8, ring 8192,
          sample 256, 4 train steps, (64, 64), Fujimoto et al.'s TD3
          settings), checked every 250 iterations up to 8,000: the first
          iteration whose last-20 return reaches -250.
  qtopt   `agents_tpu`'s `QtOptAgent` in its `FusedTrainLoop` at
          `examples/td3_pendulum_torch.py --preset=live --agent=qtopt`
          (TD3's live construction with the critic alone, CEM 32/4/3
          over the target critic, delayed targets every 5 steps,
          epsilon-greedy 0.1), run for the whole 8,000 iterations and
          checked every 250: the first check at -250 or more, and the
          last-20 return at the end. `qtopt_bar` turns the five seeds'
          runs into the bar.
  ppo_rnn `agents_tpu`'s `PPOAgent` with LSTM actor and value networks in
          its `OnPolicyTrainLoop` at `examples/ppo_cartpole_torch.py
          --preset=rnn_learn` (the config of `tests/test_ppo_rnn.py:87-107`:
          B=8, T=48, input (32,), LSTM 16, output (32,), 4 epochs x 2
          minibatches, entropy 0.01, Adam 1e-3) for its 30 iterations: the
          last-20 return at the end. `ppo_rnn_bar` turns the five seeds'
          returns into the bar.
  per     `agents_tpu`'s `DqnAgent` in its `FusedTrainLoop` with
          `PrioritizedReplay` at `tests/test_prioritized_replay.py:165-204`'s
          config (`PER`: B=32 CartPoles, ring 256, (64, 64), eps 0.1, tau
          0.05 every 5, Adam 1e-3, squared loss, sample 64, 64 initial
          collect steps, alpha 0.6, beta 0.4) for 1,600 iterations: the
          last-20 return at the end. `per_bar` turns the five seeds' returns
          into the bar; `run_per(..., port=True)` runs the port's loop at the
          same config.
  host_sac `agents_tpu`'s `SacAgent` in its `HostDeviceTrainLoop` over a
          `BatchedPyEnvironment` of 8 gymnasium `Pendulum-v1`s (`HOST_SAC`:
          4 train steps per tick, (64, 64) actor and critic, ring 8192 per
          row, sample 256, 128 random ticks, Adam 3e-4, reward scale 1.0),
          checked every 250 ticks up to 8,000: the first tick whose last-20
          return reaches -250. `host_sac_bar` turns the five seeds' runs
          into the bar; `run_host_sac(..., port=True)` runs the port's
          `HostDeviceTrainLoop` at the same config.
  bandit  `agents_tpu`'s bandit example (`examples/bandits_train_eval.py`)
          at its default `Config` (B=256, 1,000 rounds, d=8, K=5, noise
          0.1, Adam 1e-2, (64, 64) reward nets) for the
          `linucb_stationary` and `neural_eps_greedy` scenarios: the
          regret and suboptimal-arm share of the last 200-round window.
          `bandit_bar` turns the five seeds' runs into the bar of
          `chip_smoke.py`'s `bandit_learn` (`BANDIT_BARS`);
          `run_bandit(..., port=True)` runs the port's example.
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
  behavior phase A of the same offline pipeline alone (the SAC behaviour
          run of `tests/test_cql_offline_e2e.py:38-54`, checked every 250
          iterations up to 6,000 for a last-20 return above -250), then
          its greedy return over 10 episodes; `behavior_port` runs the
          port's `behavior_phase` on the CPU at the same config. Five seeds
          of each give the two distributions of ROADMAP C2 (about 30 s a
          JAX seed and 60-90 s a port seed on one core; ``--behavior-seed=N``
          runs one).

Run them (about 10 minutes on 8 CPU cores), over seeds 0-4 for TD3 and
QtOpt and phase-C seeds 0-3 for the offline agents (one QtOpt seed takes
about 3 minutes on one core; ``--qtopt-seed=N``, repeated, runs only those
seeds, so five processes can run them side by side):

    JAX_PLATFORMS=cpu python tests/test_torch_reference_bars.py [td3]
        [offline] [qtopt [--qtopt-seed=N ...]] [ppo_rnn]
        [host_sac [--host-sac-seed=N ...]] [per] [bandit]
        [behavior|behavior_port [--behavior-seed=N ...]]

(`ppo_rnn` takes about a minute a seed on one core; `host_sac` a minute or
two; `host_sac_port` runs the port at `HOST_SAC` over the same seeds; `per`
and `per_port` under a minute a seed; `bandit` and `bandit_port` a few
seconds a scenario and seed.)

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

import pytest

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


def jax_qtopt_loop(cfg):
  """The JAX `FusedTrainLoop` of the example's `--agent=qtopt` config."""
  from agents_tpu import metrics, networks
  from agents_tpu.agents.qtopt import QtOptAgent
  from agents_tpu.environments.classic.pendulum import Pendulum
  from agents_tpu.environments.jax_environment import BatchedJaxEnv
  from agents_tpu.replay_buffers import UniformReplay
  from agents_tpu.train import FusedTrainLoop
  from agents_tpu.trajectories import trajectory as tj

  env = BatchedJaxEnv(Pendulum(cfg.max_episode_steps),
                      batch_size=cfg.env_batch_size)
  tss, asp = env.time_step_spec(), env.action_spec()
  critic = networks.make_critic_network(
      tss.observation, asp, joint_fc_layer_params=cfg.critic_joint_fc_layers)
  agent = QtOptAgent(
      tss, asp, critic, _adam(cfg.critic_lr),
      target_update_tau=cfg.target_update_tau,
      target_update_period=cfg.target_update_period, gamma=cfg.gamma,
      reward_scale_factor=cfg.reward_scale_factor)
  replay = UniformReplay(tj.trajectory_spec(tss, asp), cfg.env_batch_size,
                         cfg.replay_capacity)
  return FusedTrainLoop(env, agent, replay,
                        metrics=metrics.standard_collect_metrics(
                            cfg.return_buffer),
                        sample_batch_size=cfg.sample_batch_size,
                        train_steps_per_iteration=cfg.train_steps_per_iteration)


def run_qtopt_bar(cfg):
  """QtOpt's whole 8,000-iteration budget, the last-20 return checked every
  250: the first check at -250 or more, the return at the end, and greedy
  eval over 30 episodes. Unlike `run_td3_bar` it does not stop at the gate,
  since the bar may be set by the returns at the end."""
  import jax
  import numpy as np

  loop = jax_qtopt_loop(cfg)
  state = jax.jit(lambda k: loop.init(
      k, initial_collect_steps=cfg.initial_collect_steps))(
          jax.random.key(cfg.seed))
  run = jax.jit(lambda s: loop.run(s, LEARN_CHUNK))
  points, iterations, passed_at = [], 0, None
  t0 = time.time()
  while iterations < cfg.num_iterations:
    state, _ = run(state)
    iterations += LEARN_CHUNK
    ret = float(np.asarray(loop.results(state)["AverageReturn"]))
    points.append([iterations, ret])
    print(f"qtopt seed {cfg.seed} {iterations}: {ret:.2f}", flush=True)
    if passed_at is None and ret >= LEARN_GATE:
      passed_at = iterations
  out = loop.evaluate(state, jax.random.key(cfg.seed + 101), num_episodes=30,
                      max_steps=2000)
  return {"passed_at": passed_at, "last20_average_return": ret,
          "points": points, "eval_episodes": int(out["NumberOfEpisodes"]),
          "eval_average_return": float(out["AverageReturn"]),
          "seconds": time.time() - t0}


def qtopt_bar(runs):
  """The `qtopt_learn` bar from the JAX runs over seeds 0-4: -250 within the
  budget if at least 3 of 5 seeds pass it; otherwise the worst seed's
  last-20 return at the end less a third of the spread across seeds."""
  if sum(r["passed_at"] is not None for r in runs) >= 3:
    return LEARN_GATE
  finals = [r["last20_average_return"] for r in runs]
  return min(finals) - (max(finals) - min(finals)) / 3.0


PPO_RNN_GATE = 35.0


def jax_ppo_rnn_loop(cfg):
  """The JAX `OnPolicyTrainLoop` of the example's `--preset=rnn_learn`."""
  from agents_tpu import metrics, networks
  from agents_tpu.agents.ppo import PPOAgent
  from agents_tpu.environments.classic.cartpole import CartPole
  from agents_tpu.environments.jax_environment import BatchedJaxEnv
  from agents_tpu.train import OnPolicyTrainLoop

  env = BatchedJaxEnv(CartPole(cfg.max_episode_steps),
                      batch_size=cfg.env_batch_size)
  tss, asp = env.time_step_spec(), env.action_spec()
  rnn = dict(lstm_size=cfg.lstm_size,
             output_fc_layer_params=cfg.lstm_output_fc_layers)
  agent = PPOAgent(
      tss, asp, _adam(cfg.learning_rate),
      networks.make_actor_distribution_rnn_network(
          tss.observation, asp, input_fc_layer_params=cfg.actor_fc_layers,
          **rnn),
      networks.make_value_rnn_network(
          tss.observation, input_fc_layer_params=cfg.value_fc_layers, **rnn),
      importance_ratio_clipping=cfg.importance_ratio_clipping,
      discount_factor=cfg.discount_factor, lambda_value=cfg.lambda_value,
      num_epochs=cfg.num_epochs, num_minibatches=cfg.num_minibatches,
      entropy_regularization=cfg.entropy_regularization)
  return OnPolicyTrainLoop(env, agent,
                           metrics.standard_collect_metrics(cfg.return_buffer),
                           rollout_length=cfg.rollout_length)


def run_ppo_rnn_bar(cfg):
  """The whole `cfg.num_iterations`, the last-20 return every 5."""
  import jax
  import numpy as np

  loop = jax_ppo_rnn_loop(cfg)
  state = jax.jit(loop.init)(jax.random.key(cfg.seed))
  run = jax.jit(lambda s: loop.run(s, 5))
  points, t0 = [], time.time()
  for iterations in range(5, cfg.num_iterations + 1, 5):
    state, _ = run(state)
    points.append([iterations, float(np.asarray(
        loop.results(state)["AverageReturn"]))])
  return {"last20_average_return": points[-1][1], "points": points,
          "seconds": time.time() - t0}


def ppo_rnn_bar(runs):
  """The `ppo_rnn_learn` bar from the JAX runs over seeds 0-4: the JAX
  test's 35 unless all five clear it; then the worst seed's return less a
  third of the spread across seeds, and never under 35."""
  finals = [r["last20_average_return"] for r in runs]
  if min(finals) <= PPO_RNN_GATE:
    return PPO_RNN_GATE
  return max(PPO_RNN_GATE, min(finals) - (max(finals) - min(finals)) / 3.0)


HOST_SAC = dict(env_batch_size=8, train_steps_per_tick=4, fc=(64, 64),
                replay_capacity=8192, sample_batch_size=256,
                initial_random_ticks=128, max_ticks=8000, chunk=250, lr=3e-4)


def _host_sac_loop(seed, port):
  """The JAX package's (or the port's, on the CPU) `HostDeviceTrainLoop`
  of SAC at `HOST_SAC` over 8 gymnasium Pendulums seeded from `seed`."""
  c = HOST_SAC
  if port:
    import torch

    from agents_tpu_torch.agents.sac import SacAgent
    from agents_tpu_torch.environments import suite_gym
    from agents_tpu_torch.environments.batched_py_environment import \
        BatchedPyEnvironment
    from agents_tpu_torch.metrics import py_metrics
    from agents_tpu_torch.networks import (make_critic_network,
                                           make_sac_actor_network)
    from agents_tpu_torch.replay_buffers import UniformReplay
    from agents_tpu_torch.train import HostDeviceTrainLoop
    from agents_tpu_torch.trajectories import trajectory as tj
  else:
    from agents_tpu import networks
    from agents_tpu.agents.sac import SacAgent
    from agents_tpu.environments import suite_gym
    from agents_tpu.environments.batched_py_environment import \
        BatchedPyEnvironment
    from agents_tpu.metrics import py_metrics
    from agents_tpu.replay_buffers import UniformReplay
    from agents_tpu.train import HostDeviceTrainLoop
    from agents_tpu.trajectories import trajectory as tj

  env = BatchedPyEnvironment([suite_gym.load("Pendulum-v1")
                              for _ in range(c["env_batch_size"])])
  env.seed(seed * 1000)
  tss, asp = env.time_step_spec(), env.action_spec()
  metrics = [py_metrics.AverageReturnMetric(20)]
  if port:
    g = torch.Generator().manual_seed(seed)
    adam = lambda p: torch.optim.Adam(p, lr=c["lr"])  # noqa: E731
    agent = SacAgent(
        tss, asp,
        make_critic_network(tss.observation, asp,
                            joint_fc_layer_params=c["fc"], device="cpu",
                            generator=g),
        make_sac_actor_network(tss.observation, asp,
                               fc_layer_params=c["fc"], device="cpu",
                               generator=g),
        adam, adam, adam, generator=g, device="cpu")
    replay = UniformReplay(tj.trajectory_spec(tss, asp),
                           c["env_batch_size"], c["replay_capacity"],
                           device="cpu")
    kw = dict(device="cpu")
  else:
    agent = SacAgent(
        tss, asp,
        critic_network=networks.make_critic_network(
            tss.observation, asp, joint_fc_layer_params=c["fc"]),
        actor_network=networks.make_sac_actor_network(
            tss.observation, asp, fc_layer_params=c["fc"]),
        actor_optimizer=_adam(c["lr"]), critic_optimizer=_adam(c["lr"]),
        alpha_optimizer=_adam(c["lr"]))
    replay = UniformReplay(tj.trajectory_spec(tss, asp),
                           c["env_batch_size"], c["replay_capacity"])
    kw = {}
  return HostDeviceTrainLoop(env, agent, replay,
                             train_steps_per_tick=c["train_steps_per_tick"],
                             sample_batch_size=c["sample_batch_size"],
                             py_metrics=metrics, **kw)


def run_host_sac(seed, port=False, max_ticks=None):
  """Random ticks, then chunks of 250 ticks up to `max_ticks`, stopping at
  the first check whose last-20 return reaches -250."""
  c = HOST_SAC
  max_ticks = max_ticks or c["max_ticks"]
  loop = _host_sac_loop(seed, port)
  dev, time_step = loop.init(seed)
  dev, time_step, prev, action = loop.collect(
      dev, time_step, c["initial_random_ticks"], seed=seed)
  ticks, points, passed_at, t0 = 0, [], None, time.time()
  while ticks < max_ticks:
    dev, time_step, prev, action, loss = loop.run(dev, time_step, prev,
                                                  action, c["chunk"])
    ticks += c["chunk"]
    ret = float(loop.metric_results()["AverageReturn"])
    points.append([ticks, ret, loss])
    if ret >= LEARN_GATE:
      passed_at = ticks
      break
  loop.env.close()
  return {"passed_at": passed_at, "last20_average_return": points[-1][1],
          "points": points, "seconds": time.time() - t0}




PER = dict(env_batch_size=32, replay_capacity=256, sample_batch_size=64,
           fc_layer_params=(64, 64), initial_collect_steps=64,
           iterations=1600, alpha=0.6, beta=0.4)
PER_GATE = 100.0


def port_per_loop(seed=0, device="cpu"):
  """The port's `FusedTrainLoop` with `PrioritizedReplay` at `PER`: the
  DQN example's loop at that config, its replay made prioritized."""
  from agents_tpu_torch.replay_buffers import PrioritizedReplay
  from agents_tpu_torch.train import FusedTrainLoop
  from examples.dqn_cartpole_torch import Config, build_loop

  c = PER
  loop = build_loop(Config(
      env_batch_size=c["env_batch_size"], replay_capacity=c["replay_capacity"],
      sample_batch_size=c["sample_batch_size"],
      fc_layer_params=c["fc_layer_params"], seed=seed, device=device))
  replay = PrioritizedReplay(loop.replay.data_spec, c["env_batch_size"],
                             c["replay_capacity"], alpha=c["alpha"],
                             device=device)
  return FusedTrainLoop(loop.env, loop.agent, replay, metrics=loop.metrics,
                        sample_batch_size=c["sample_batch_size"],
                        per_beta=c["beta"], device=device)


def jax_per_loop():
  """The JAX loop of `tests/test_prioritized_replay.py:165-204`."""
  from agents_tpu import metrics, networks
  from agents_tpu.agents.dqn import DqnAgent
  from agents_tpu.environments.classic.cartpole import CartPole
  from agents_tpu.environments.jax_environment import BatchedJaxEnv
  from agents_tpu.replay_buffers import PrioritizedReplay
  from agents_tpu.train import FusedTrainLoop
  from agents_tpu.trajectories import trajectory as tj
  from agents_tpu.utils import common

  c = PER
  env = BatchedJaxEnv(CartPole(), batch_size=c["env_batch_size"])
  tss, asp = env.time_step_spec(), env.action_spec()
  qnet = networks.make_q_network(tss.observation, asp,
                                 fc_layer_params=c["fc_layer_params"])
  agent = DqnAgent(tss, asp, qnet, _adam(1e-3), epsilon_greedy=0.1,
                   target_update_tau=0.05, target_update_period=5,
                   gamma=0.99,
                   td_errors_loss_fn=common.element_wise_squared_loss)
  rb = PrioritizedReplay(tj.trajectory_spec(tss, asp),
                         batch_size=c["env_batch_size"],
                         max_length=c["replay_capacity"], alpha=c["alpha"])
  return FusedTrainLoop(env, agent, rb,
                        metrics=metrics.standard_collect_metrics(20),
                        collect_steps_per_iteration=1,
                        sample_batch_size=c["sample_batch_size"],
                        per_beta=c["beta"])


def run_per(seed, port=False):
  """`PER["iterations"]` iterations from `seed` (the JAX loop from
  ``key(seed)``, the port's from ``Draws(seed)`` on the CPU): the last-20
  return, the losses' finiteness and the priorities' spread."""
  import numpy as np

  c, t0 = PER, time.time()
  if port:
    import torch

    loop = port_per_loop(seed)
    state = loop.init(seed, initial_collect_steps=c["initial_collect_steps"])
    state, losses = loop.run(state, c["iterations"])
    finite = bool(torch.isfinite(losses).all())
  else:
    import jax

    loop = jax_per_loop()
    state = jax.jit(lambda k: loop.init(
        k, initial_collect_steps=c["initial_collect_steps"]))(
            jax.random.key(seed))
    state, losses = jax.jit(lambda s: loop.run(s, c["iterations"]))(state)
    finite = bool(np.isfinite(np.asarray(losses)).all())
  return {"last20_average_return": float(np.asarray(
      loop.results(state)["AverageReturn"])), "losses_finite": finite,
          "priority_std": float(np.asarray(
              state.replay_state.priorities).std()),
          "seconds": time.time() - t0}


def per_bar(runs):
  """The PER bar from the JAX runs over seeds 0-4: the JAX test's 100
  unless all five clear it; then the worst seed's return less a third of
  the spread across seeds, and never under 100."""
  finals = [r["last20_average_return"] for r in runs]
  if min(finals) <= PER_GATE:
    return PER_GATE
  return max(PER_GATE, min(finals) - (max(finals) - min(finals)) / 3.0)


BANDIT_SCENARIOS = ("linucb_stationary", "neural_eps_greedy")
# `bandit_bar` over the JAX example's runs, seeds 0-4 (`python
# tests/test_torch_reference_bars.py bandit`): per scenario, the largest
# regret and suboptimal-arm share a port run may end with. LinUCB's
# regrets were 1.599e-4, -2.375e-4, 2.737e-5, -3.765e-4 and 3.200e-4
# (suboptimal shares 7.23e-4 to 3.027e-3); the neural agent's 0.1443,
# 0.1942, 0.1792, 0.2202 and 0.2026 (0.1042 to 0.1132).
BANDIT_BARS = {
    "linucb_stationary": {"regret": 0.0005521289228151242,
                          "suboptimal_arms": 0.003795572789385915},
    "neural_eps_greedy": {"regret": 0.24547086159388223,
                          "suboptimal_arms": 0.1161718765894572},
}


def run_bandit(scenario, seed, port=False):
  """The bandit example's default config for `scenario` from `seed` (the
  JAX example's loop from ``key(seed)``; the port's example on the CPU):
  the regret and suboptimal-arm share of its last `log_interval`
  window."""
  t0 = time.time()
  if port:
    from examples import bandits_train_eval_torch as example
    with tempfile.TemporaryDirectory(prefix="bandit_bar_") as root_dir:
      cfg = example.Config(seed=seed, device="cpu", root_dir=root_dir)
      _, records = example.train_eval(cfg, scenario)
    last = records[-1]
  else:
    import jax

    from agents_tpu.bandits.metrics import (RegretMetric,
                                            SuboptimalArmsMetric)
    from agents_tpu.environments.jax_environment import BatchedJaxEnv
    from agents_tpu.train import OnPolicyTrainLoop
    from examples import bandits_train_eval as example
    cfg = example.Config(seed=seed)
    env1, agent = example.SCENARIOS[scenario](cfg)
    metrics = (RegretMetric(env1.optimal_reward_fn),
               SuboptimalArmsMetric(env1.optimal_action_fn))
    loop = OnPolicyTrainLoop(BatchedJaxEnv(env1, cfg.env_batch_size),
                             agent, metrics, rollout_length=2)
    state = loop.init(jax.random.key(seed))
    run = jax.jit(lambda s, n: loop.run(s, n), static_argnums=1)
    for _ in range(cfg.num_rounds // cfg.log_interval):
      state = state.replace(metric_states=tuple(
          m.init(cfg.env_batch_size) for m in metrics))
      state, _ = run(state, cfg.log_interval)
    last = {k: float(v) for k, v in loop.results(state).items()}
  return {"scenario": scenario, "seed": seed,
          "regret": last["RegretMetric"],
          "suboptimal_arms": last["SuboptimalArmsMetric"],
          "seconds": time.time() - t0}


def bandit_bar(runs):
  """The `bandit_learn` bar of one scenario from the JAX runs over seeds
  0-4: for the regret and for the suboptimal-arm share, the worst seed's
  value plus a third of the spread across seeds (lower is better)."""
  out = {}
  for key in ("regret", "suboptimal_arms"):
    vals = [r[key] for r in runs]
    out[key] = max(vals) + (max(vals) - min(vals)) / 3.0
  return out


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


def run_behavior(seed, port=False):
  """Phase A of the offline device pipeline from `seed`: the SAC behaviour
  run of `tests/test_cql_offline_e2e.py:38-54` with the JAX package, or
  `examples/cql_sac_offline_torch.py:behavior_phase` with the port on the
  CPU, at that pipeline's config (B=8, (64, 64), ring 4096, 2 train steps
  of 128, 128 initial collect steps, checked every 250 iterations up to
  6,000 for a last-20 return above -250); then the greedy return over 10
  episodes."""
  import numpy as np

  from examples.cql_sac_offline_torch import Config

  cfg = dataclasses.replace(Config(device="cpu"), seed=seed)
  t0 = time.time()
  if port:
    from examples import cql_sac_offline_torch as ex
    env = ex.build_env(cfg)
    agent, state, iterations, last20 = ex.behavior_phase(cfg, env)
    greedy, _ = ex.greedy_eval(cfg, env, agent, state, 10, 7)
  else:
    import jax

    from agents_tpu import metrics
    from agents_tpu.agents.sac import SacAgent
    from agents_tpu.environments.classic.pendulum import Pendulum
    from agents_tpu.environments.jax_environment import BatchedJaxEnv
    from agents_tpu.eval import metric_utils
    from agents_tpu.replay_buffers import UniformReplay
    from agents_tpu.train import FusedTrainLoop
    from agents_tpu.trajectories import trajectory as tj

    env = BatchedJaxEnv(Pendulum(cfg.max_episode_steps),
                        batch_size=cfg.env_batch_size)
    tss, asp = env.time_step_spec(), env.action_spec()
    agent = SacAgent(tss, asp, **_sac_kwargs(cfg, tss, asp))
    replay = UniformReplay(tj.trajectory_spec(tss, asp), cfg.env_batch_size,
                           cfg.behavior_replay_capacity)
    loop = FusedTrainLoop(env, agent, replay,
                          metrics=metrics.standard_collect_metrics(20),
                          sample_batch_size=cfg.behavior_sample_batch_size,
                          train_steps_per_iteration=cfg.behavior_train_steps)
    state = jax.jit(lambda k: loop.init(
        k, initial_collect_steps=cfg.behavior_initial_collect_steps))(
            jax.random.key(seed))
    run = jax.jit(lambda s: loop.run(s, cfg.behavior_chunk))
    iterations, last20 = 0, -math.inf
    while iterations < cfg.behavior_iterations:
      state, _ = run(state)
      iterations += cfg.behavior_chunk
      last20 = float(np.asarray(loop.results(state)["AverageReturn"]))
      if last20 > cfg.behavior_gate:
        break
    greedy = float(metric_utils.evaluate_jax_env_episodes(
        env, agent.policy, agent.policy_params(state.agent_state),
        jax.random.key(7), num_episodes=10, max_steps=2000)["AverageReturn"])
  return {"seed": seed, "port": port, "iterations": iterations,
          "passed": last20 > cfg.behavior_gate, "last20_average_return":
          last20, "greedy_return_10": greedy, "seconds": time.time() - t0}


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


def test_qtopt_bar_runs_the_live_preset_and_takes_an_iteration():
  """The JAX QtOpt loop of the port's `--preset=live --agent=qtopt` config:
  its replay, train steps, widths and QtOpt settings, and one fused
  iteration with a finite loss."""
  import jax
  import numpy as np

  from agents_tpu.policies.wrappers import EpsilonGreedyPolicy
  from examples.td3_pendulum_torch import parse_td3_args

  cfg = parse_td3_args(["--preset=live", "--agent=qtopt"])
  loop = jax_qtopt_loop(cfg)
  agent = loop.agent
  assert (loop.env.batch_size, loop.replay.capacity, loop.sample_batch_size,
          loop.train_steps) == (8, 8192, 256, 4)
  assert (agent.policy.num_samples, agent.policy.num_elites,
          agent.policy.num_iterations, agent.enable_td3,
          agent.delayed_target_update_period, agent.target_update_tau,
          agent.gamma) == (32, 4, 3, True, 5, 0.005, 0.99)
  assert isinstance(agent.collect_policy, EpsilonGreedyPolicy)
  state = loop.init(jax.random.key(0), initial_collect_steps=8)
  state, losses = loop.run(state, 1)
  assert np.isfinite(np.asarray(losses)).all()
  assert int(state.agent_state.train_step) == 4


def test_qtopt_bar_rule():
  """-250 when 3 of 5 seeds pass it; else the worst last-20 return less a
  third of the spread."""
  runs = [{"passed_at": p, "last20_average_return": r}
          for p, r in ((2000, -200.0), (None, -400.0), (3000, -180.0),
                       (None, -500.0), (7000, -240.0))]
  assert qtopt_bar(runs) == LEARN_GATE
  for r in runs[:2]:
    r["passed_at"] = None
  assert qtopt_bar(runs) == -500.0 - (500.0 - 180.0) / 3.0


def test_ppo_rnn_bar_runs_the_rnn_learn_preset():
  """The JAX loop of the port's `--preset=rnn_learn`: its batch, rollout,
  widths and PPO settings, and one iteration with a finite loss."""
  import jax
  import numpy as np

  from examples.ppo_cartpole_torch import parse_ppo_args

  cfg = parse_ppo_args(["--preset=rnn_learn"])
  loop = jax_ppo_rnn_loop(cfg)
  agent = loop.agent
  assert (loop.env.batch_size, loop.rollout_length, cfg.num_iterations) == (
      8, 48, 30)
  assert (agent.num_epochs, agent.num_minibatches,
          agent.entropy_regularization, agent._recurrent) == (4, 2, 0.01,
                                                               True)
  params = agent.actor_network.init_params(jax.random.key(0))["params"]
  encoder = params["LSTMEncoderModule_0"]
  assert encoder["Dense_0"]["kernel"].shape == (4, 32)
  assert encoder["Dense_1"]["kernel"].shape == (16, 32)
  state = loop.init(jax.random.key(0))
  state, losses = loop.run(state, 1)
  assert np.isfinite(np.asarray(losses)).all()


def test_ppo_rnn_bar_rule():
  runs = [{"last20_average_return": r} for r in (60.0, 90.0, 75.0, 48.0,
                                                 120.0)]
  assert ppo_rnn_bar(runs) == PPO_RNN_GATE
  runs[3]["last20_average_return"] = 84.0
  assert ppo_rnn_bar(runs) == 60.0 - (120.0 - 60.0) / 3.0
  runs[0]["last20_average_return"] = 30.0
  assert ppo_rnn_bar(runs) == PPO_RNN_GATE


# The JAX package's host SAC at `HOST_SAC` passes -250 at 2,250, 2,250,
# 2,250, 2,250 and 2,750 ticks over seeds 0-4 (`python
# tests/test_torch_reference_bars.py host_sac`), so by `qtopt_bar`'s rule
# the bar is -250 within the 8,000-tick budget.
HOST_SAC_BAR = LEARN_GATE


@pytest.mark.parametrize("port", [False, True], ids=["jax", "port"])
def test_host_sac_bar_runs_the_host_sac_config(port):
  """The JAX and the port loop of `HOST_SAC`: 8 gymnasium Pendulums, 4
  train steps of 256 per tick, a ring of 8192 per row, (64, 64) networks;
  random ticks and one policy tick with a finite loss."""
  import numpy as np

  loop = _host_sac_loop(0, port)
  assert (loop.env.batch_size, loop.train_steps_per_tick,
          loop.sample_batch_size, loop.replay.capacity) == (8, 4, 256, 8192)
  assert loop.agent.reward_scale_factor == 1.0
  dev, time_step = loop.init(0)
  dev, time_step, prev, action = loop.collect(dev, time_step, 3)
  _, _, _, _, loss = loop.run(dev, time_step, prev, action, 1)
  assert np.isfinite(loss)
  assert loop.metric_results() == {"AverageReturn": 0.0}
  loop.env.close()


def test_host_sac_bar_rule():
  runs = [{"passed_at": p, "last20_average_return": -200.0}
          for p in (2250, 2250, 2250, 2250, 2750)]
  assert qtopt_bar(runs) == HOST_SAC_BAR


def test_per_bar_runs_the_jax_test_config():
  """The JAX PER loop is `tests/test_prioritized_replay.py`'s (B=32, ring
  256, (64, 64), sample 64, alpha 0.6, beta 0.4) and the port's loop has
  the same widths and settings; one iteration each with finite losses."""
  import jax
  import numpy as np
  import torch

  jloop, tloop = jax_per_loop(), port_per_loop()
  for loop in (jloop, tloop):
    assert (loop.env.batch_size, loop.replay.capacity, loop.replay.alpha,
            loop.sample_batch_size, loop.per_beta, loop.prioritized) == (
                32, 256, 0.6, 64, 0.4, True)
    assert (loop.agent.epsilon_greedy, loop.agent.gamma,
            loop.agent.target_update_tau,
            loop.agent.target_update_period) == (0.1, 0.99, 0.05, 5)
  assert [m.in_features for m in tloop.agent.q_network.modules()
          if isinstance(m, torch.nn.Linear)] == [4, 64, 64]
  jstate = jloop.init(jax.random.key(0), initial_collect_steps=4)
  _, jlosses = jloop.run(jstate, 1)
  tstate = tloop.init(0, initial_collect_steps=4)
  _, tlosses = tloop.run(tstate, 1)
  assert np.isfinite(np.asarray(jlosses)).all()
  assert torch.isfinite(tlosses).all()


def test_per_bar_rule():
  runs = [{"last20_average_return": r}
          for r in (192.75, 200.0, 157.85, 192.0, 117.2)]
  assert per_bar(runs) == PER_GATE        # 117.2 - 82.8 / 3 < 100
  runs[4]["last20_average_return"] = 180.0
  assert per_bar(runs) == 157.85 - (200.0 - 157.85) / 3.0
  runs[0]["last20_average_return"] = 90.0
  assert per_bar(runs) == PER_GATE


def test_bandit_bar_runs_the_example_config():
  """The JAX bandit runs are the JAX example's default config, which the
  port's example shares; a short run of each scenario gives finite
  metrics in both packages."""
  from examples import bandits_train_eval as jexample
  from examples import bandits_train_eval_torch as texample

  j = dataclasses.asdict(jexample.Config())
  t = dataclasses.asdict(texample.Config())
  assert {k: v for k, v in t.items() if k not in ("root_dir", "device")} \
      == {k: v for k, v in j.items() if k != "root_dir"}
  assert (j["env_batch_size"], j["num_rounds"], j["log_interval"]) == (
      256, 1000, 200)
  assert set(BANDIT_BARS) == set(BANDIT_SCENARIOS)
  import chip_smoke
  assert chip_smoke.BANDIT_LEARN_BARS == BANDIT_BARS


def test_bandit_bar_rule():
  runs = [{"regret": r, "suboptimal_arms": s}
          for r, s in ((0.1, 0.2), (0.4, 0.1), (0.25, 0.3))]
  bar = bandit_bar(runs)
  assert math.isclose(bar["regret"], 0.4 + 0.3 / 3)
  assert math.isclose(bar["suboptimal_arms"], 0.3 + 0.2 / 3)


@pytest.mark.parametrize("scenario", BANDIT_SCENARIOS)
def test_port_bandit_passes_the_jax_bar(scenario):
  """The port's example on the CPU at the default config (seed 0) ends
  within the JAX bar (a few seconds)."""
  out = run_bandit(scenario, 0, port=True)
  for key in ("regret", "suboptimal_arms"):
    assert out[key] <= BANDIT_BARS[scenario][key], (key, out)


@pytest.mark.slow
def test_port_host_sac_passes_the_jax_bar():
  """The port's `HostDeviceTrainLoop` SAC at `HOST_SAC` on the CPU reaches
  a last-20 return of -250 within the 8,000-tick budget (about 80 s on one
  core; it passes at 2,000-2,250 ticks)."""
  out = run_host_sac(0, port=True)
  assert out["passed_at"] is not None, out["points"][-3:]
  assert out["last20_average_return"] >= HOST_SAC_BAR


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

  which = sys.argv[1:] or ["td3", "offline", "qtopt", "ppo_rnn", "host_sac"]
  if "td3" in which:
    for seed in range(5):
      td3 = run_td3_bar(dataclasses.replace(parse_td3_args(["--preset=live"]),
                                            seed=seed))
      print(json.dumps({"td3_live_seed": seed, **{
          k: v for k, v in td3.items() if k != "points"}}), flush=True)
  if "qtopt" in which:
    seeds = [int(s.split("=", 1)[1]) for s in which
             if s.startswith("--qtopt-seed=")] or list(range(5))
    qtopt_runs = []
    for seed in seeds:
      qtopt_runs.append(run_qtopt_bar(dataclasses.replace(
          parse_td3_args(["--preset=live", "--agent=qtopt"]), seed=seed)))
      print(json.dumps({"qtopt_live_seed": seed, **qtopt_runs[-1]}),
            flush=True)
    if len(qtopt_runs) == 5:
      print(json.dumps({"qtopt_bar": qtopt_bar(qtopt_runs)}), flush=True)
  if "ppo_rnn" in which:
    from examples.ppo_cartpole_torch import parse_ppo_args
    ppo_rnn_runs = []
    for seed in range(5):
      ppo_rnn_runs.append(run_ppo_rnn_bar(dataclasses.replace(
          parse_ppo_args(["--preset=rnn_learn"]), seed=seed)))
      print(json.dumps({"ppo_rnn_seed": seed, **ppo_rnn_runs[-1]}),
            flush=True)
    print(json.dumps({"ppo_rnn_bar": ppo_rnn_bar(ppo_rnn_runs)}), flush=True)
  for mode, port in (("host_sac", False), ("host_sac_port", True)):
    if mode not in which:
      continue
    seeds = [int(s.split("=", 1)[1]) for s in which
             if s.startswith("--host-sac-seed=")] or list(range(5))
    host_runs = []
    for seed in seeds:
      host_runs.append(run_host_sac(seed, port=port))
      print(json.dumps({f"{mode}_seed": seed, **host_runs[-1]}), flush=True)
    if len(host_runs) == 5:
      print(json.dumps({f"{mode}_bar": qtopt_bar(host_runs)}), flush=True)
  for mode, port in (("per", False), ("per_port", True)):
    if mode not in which:
      continue
    per_runs = []
    for seed in range(5):
      per_runs.append(run_per(seed, port=port))
      print(json.dumps({f"{mode}_seed": seed, **per_runs[-1]}), flush=True)
    print(json.dumps({f"{mode}_bar": per_bar(per_runs)}), flush=True)
  for mode, port in (("bandit", False), ("bandit_port", True)):
    if mode not in which:
      continue
    for scenario in BANDIT_SCENARIOS:
      bandit_runs = []
      for seed in range(5):
        bandit_runs.append(run_bandit(scenario, seed, port=port))
        print(json.dumps({mode: bandit_runs[-1]}), flush=True)
      print(json.dumps({f"{mode}_bar": {scenario: bandit_bar(bandit_runs)}}),
            flush=True)
  for mode, port in (("behavior", False), ("behavior_port", True)):
    if mode not in which:
      continue
    seeds = [int(s.split("=", 1)[1]) for s in which
             if s.startswith("--behavior-seed=")] or list(range(5))
    for seed in seeds:
      print(json.dumps({mode: run_behavior(seed, port=port)}), flush=True)
  if "offline" in which:
    offline = run_offline_bars(OfflineConfig(), seeds=range(4))
    print(json.dumps({"offline": offline}), flush=True)
