"""Contextual-bandit training scenarios with the PyTorch port
(`agents_tpu_torch`).

The port of ``examples/bandits_train_eval.py``: the same 16 `SCENARIOS`
(an environment and an agent each) and the same `Config` defaults (B=256
env rows, 1,000 rounds, d=8 contexts, K=5 arms, noise 0.1, Adam 1e-2,
(64, 64) reward networks), run through `OnPolicyTrainLoop` with
`rollout_length=2` (one length-1 bandit episode per row and round: the
round's frame, then the auto-reset's boundary frame). Every
`log_interval` rounds the metric windows restart and one JSON record
(scenario, round, rounds_per_s = env-rows per second, and the regret and
suboptimal-arm metrics the scenario's env supports) is written to
``<root_dir>/<scenario>.jsonl`` and printed. The per-arm and ranking
scenarios' samplers draw at the sites "per_arm_global", "per_arm_arms",
"ranking_global" and "ranking_items" (uniform and normal features).

Usage:
  python examples/bandits_train_eval_torch.py --scenario=linucb_stationary
  python examples/bandits_train_eval_torch.py --list
  python examples/bandits_train_eval_torch.py --scenario=wheel \
      --device cpu --cfg.num_rounds=2000 --cfg.env_batch_size=512
"""
import dataclasses
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402


@dataclasses.dataclass(frozen=True)
class Config:
  root_dir: str = os.path.join(_REPO, "runs", "bandits")
  env_batch_size: int = 256
  num_rounds: int = 1000
  log_interval: int = 200
  learning_rate: float = 1e-2
  epsilon: float = 0.1
  linucb_alpha: float = 1.0
  context_dim: int = 8
  num_arms: int = 5
  noise_std: float = 0.1
  seed: int = 0
  device: str = "cuda"


def _generator(cfg):
  """The generator the scenario's networks are initialised from."""
  from agents_tpu_torch.utils.device import resolve_device
  g = torch.Generator(device=resolve_device(cfg.device))
  g.manual_seed(cfg.seed)
  return g


def _adam(cfg):
  return lambda params: torch.optim.Adam(params, lr=cfg.learning_rate)


def _tss(env):
  from agents_tpu_torch.trajectories import time_step as ts
  return ts.time_step_spec(env.observation_spec())


def _theta(cfg):
  return np.random.default_rng(cfg.seed).normal(
      size=(cfg.num_arms, cfg.context_dim)).astype(np.float32)


def _linear_env(cfg):
  from agents_tpu_torch.bandits.environments import (
      StationaryStochasticBandit)
  return StationaryStochasticBandit(_theta(cfg), noise_std=cfg.noise_std,
                                    device=cfg.device)


def _reward_net(env, cfg, layers=(64, 64)):
  from agents_tpu_torch import networks
  return networks.make_q_network(
      _tss(env).observation, env.action_spec(), fc_layer_params=layers,
      device=cfg.device, generator=_generator(cfg))


# ---------------------------------------------------------------------------
# Scenario registry: name -> (env, agent) builder, as in the JAX example.
# ---------------------------------------------------------------------------

def _linucb_stationary(cfg):
  from agents_tpu_torch.bandits.agents import LinUcbAgent
  env = _linear_env(cfg)
  return env, LinUcbAgent(_tss(env), env.action_spec(),
                          alpha=cfg.linucb_alpha, device=cfg.device)


def _lints_stationary(cfg):
  from agents_tpu_torch.bandits.agents import LinearThompsonSamplingAgent
  env = _linear_env(cfg)
  return env, LinearThompsonSamplingAgent(
      _tss(env), env.action_spec(), alpha=cfg.linucb_alpha,
      device=cfg.device)


def _neural_eps_greedy(cfg):
  from agents_tpu_torch.bandits.agents import NeuralEpsilonGreedyAgent
  env = _linear_env(cfg)
  return env, NeuralEpsilonGreedyAgent(
      _tss(env), env.action_spec(), _reward_net(env, cfg), _adam(cfg),
      epsilon=cfg.epsilon, device=cfg.device)


def _neural_boltzmann(cfg):
  from agents_tpu_torch.bandits.agents import NeuralBoltzmannAgent
  env = _linear_env(cfg)
  return env, NeuralBoltzmannAgent(
      _tss(env), env.action_spec(), _reward_net(env, cfg), _adam(cfg),
      temperature=0.5, device=cfg.device)


def _neural_falcon(cfg):
  from agents_tpu_torch.bandits.agents import NeuralFalconAgent
  env = _linear_env(cfg)
  return env, NeuralFalconAgent(
      _tss(env), env.action_spec(), _reward_net(env, cfg), _adam(cfg),
      device=cfg.device)


def _neural_linucb(cfg):
  from agents_tpu_torch.bandits.agents import NeuralLinUcbAgent
  from agents_tpu_torch.networks.encoding_network import (
      make_encoding_network)
  env = _linear_env(cfg)
  generator = _generator(cfg)
  enc = make_encoding_network(
      env.observation_spec(), fc_layer_params=(16,), device=cfg.device,
      generator=generator)
  return env, NeuralLinUcbAgent(
      _tss(env), env.action_spec(), enc, encoding_dim=16,
      optimizer_fn=_adam(cfg), alpha=cfg.linucb_alpha, device=cfg.device,
      generator=generator)


class DropNet(torch.nn.Module):
  """Dense(64) -> ReLU -> dropout(rate) -> Dense(num_actions), with flax's
  Dense initializer; dropout only when `dropout_draws` is given (at act
  time), its keep-mask at the site "dropout_keep"."""

  def __init__(self, input_dim, num_actions, rate=0.1, width=64,
               device="cuda", generator=None):
    from agents_tpu_torch.bandits.networks.global_and_arm_feature_network \
        import dense
    super().__init__()
    self.rate = rate
    self.hidden = dense(input_dim, width, device, generator)
    self.out = dense(width, num_actions, device, generator)
    self.state_spec = ()

  def forward(self, obs, step_type=None, state=(), dropout_draws=None):
    from agents_tpu_torch.bandits.agents.mixture_and_ranking_agents import (
        dropout_keep_mask)
    x = torch.relu(self.hidden(obs.float()))
    if dropout_draws is not None:
      keep = dropout_keep_mask(dropout_draws, x.shape, self.rate)
      x = torch.where(keep, x / (1.0 - self.rate), 0.0)
    return self.out(x), state


def _dropout_ts(cfg):
  from agents_tpu_torch.bandits.agents import DropoutThompsonSamplingAgent
  from agents_tpu_torch.utils.device import resolve_device
  env = _linear_env(cfg)
  net = DropNet(cfg.context_dim, env.action_spec().num_values,
                device=resolve_device(cfg.device),
                generator=_generator(cfg))
  return env, DropoutThompsonSamplingAgent(
      _tss(env), env.action_spec(), net, _adam(cfg), device=cfg.device)


def _bernoulli_ts(cfg):
  from agents_tpu_torch.bandits.agents import BernoulliThompsonSamplingAgent
  from agents_tpu_torch.bandits.environments import BernoulliBandit
  env = BernoulliBandit([0.3, 0.5, 0.7, 0.65], device=cfg.device)
  return env, BernoulliThompsonSamplingAgent(_tss(env), env.action_spec(),
                                             device=cfg.device)


def _exp3(cfg):
  from agents_tpu_torch.bandits.agents import Exp3Agent
  from agents_tpu_torch.bandits.environments import BernoulliBandit
  env = BernoulliBandit([0.2, 0.8, 0.5], device=cfg.device)
  return env, Exp3Agent(_tss(env), env.action_spec(), learning_rate=0.05,
                        device=cfg.device)


def _exp3_mixture(cfg):
  from agents_tpu_torch.bandits.agents import (BernoulliThompsonSamplingAgent,
                                               Exp3Agent, Exp3MixtureAgent)
  from agents_tpu_torch.bandits.environments import BernoulliBandit
  env = BernoulliBandit([0.2, 0.8, 0.5], device=cfg.device)
  tss, asp = _tss(env), env.action_spec()
  subs = [Exp3Agent(tss, asp, learning_rate=0.05, device=cfg.device),
          BernoulliThompsonSamplingAgent(tss, asp, device=cfg.device)]
  return env, Exp3MixtureAgent(tss, asp, subs, learning_rate=0.05,
                               device=cfg.device)


def _wheel(cfg):
  from agents_tpu_torch.bandits.agents import NeuralEpsilonGreedyAgent
  from agents_tpu_torch.bandits.environments import WheelBandit
  env = WheelBandit(delta=0.5, device=cfg.device)
  return env, NeuralEpsilonGreedyAgent(
      _tss(env), env.action_spec(), _reward_net(env, cfg), _adam(cfg),
      epsilon=cfg.epsilon, device=cfg.device)


def _drifting(cfg):
  from agents_tpu_torch.bandits.agents import LinUcbAgent
  from agents_tpu_torch.bandits.environments import DriftingLinearBandit
  env = DriftingLinearBandit(_theta(cfg), drift_rate=0.005,
                             noise_std=cfg.noise_std, device=cfg.device)
  # gamma < 1: a forgetting factor for the non-stationarity.
  return env, LinUcbAgent(_tss(env), env.action_spec(),
                          alpha=cfg.linucb_alpha, gamma=0.995,
                          device=cfg.device)


def _piecewise(cfg):
  from agents_tpu_torch.bandits.agents import NeuralEpsilonGreedyAgent
  from agents_tpu_torch.bandits.environments import (
      PiecewiseStationaryStochasticBandit)
  env = PiecewiseStationaryStochasticBandit(
      context_dim=cfg.context_dim, num_arms=cfg.num_arms, num_pieces=4,
      durations=[max(cfg.num_rounds // 4, 1)], seed=cfg.seed,
      horizon=max(cfg.num_rounds * 2, 64), device=cfg.device)
  return env, NeuralEpsilonGreedyAgent(
      _tss(env), env.action_spec(), _reward_net(env, cfg), _adam(cfg),
      epsilon=cfg.epsilon, device=cfg.device)


def _movielens(cfg):
  from agents_tpu_torch.bandits.agents import NeuralEpsilonGreedyAgent
  from agents_tpu_torch.bandits.environments import (MovieLensBandit,
                                                     synthetic_ratings_matrix)
  ratings = synthetic_ratings_matrix(256, 64, rank=6, seed=cfg.seed)
  env = MovieLensBandit(ratings, rank_k=6, num_movies=20, device=cfg.device)
  return env, NeuralEpsilonGreedyAgent(
      _tss(env), env.action_spec(), _reward_net(env, cfg), _adam(cfg),
      epsilon=cfg.epsilon, device=cfg.device)


def _per_arm(cfg):
  from agents_tpu_torch.bandits.agents import NeuralEpsilonGreedyAgent
  from agents_tpu_torch.bandits.environments import (
      StationaryStochasticPerArmBandit)
  from agents_tpu_torch.bandits.networks.global_and_arm_feature_network \
      import make_global_and_arm_feature_network
  from agents_tpu_torch.bandits.specs.bandit_spec_utils import (
      create_per_arm_observation_spec)
  from agents_tpu_torch.utils.device import resolve_device
  gdim, adim, k = 4, 3, 6
  theta = torch.as_tensor(np.random.default_rng(cfg.seed).normal(
      size=(gdim + adim,)).astype(np.float32),
                          device=resolve_device(cfg.device))
  env = StationaryStochasticPerArmBandit(
      global_sampling_fn=lambda draws, shape: draws.uniform(
          "per_arm_global", tuple(shape) + (gdim,), -1, 1),
      arm_sampling_fn=lambda draws, shape: draws.uniform(
          "per_arm_arms", tuple(shape) + (adim,), -1, 1),
      reward_fn=lambda x, draws: x @ theta + cfg.noise_std * draws.normal(
          "bandit_reward_noise", x.shape[:-1]),
      expected_reward_fn=lambda x: x @ theta,
      global_dim=gdim, arm_dim=adim, max_num_actions=k)
  spec = create_per_arm_observation_spec(gdim, adim, k)
  net = make_global_and_arm_feature_network(spec, device=cfg.device,
                                            generator=_generator(cfg))
  return env, NeuralEpsilonGreedyAgent(
      _tss(env), env.action_spec(), net, _adam(cfg), epsilon=cfg.epsilon,
      device=cfg.device)


def _ranking(cfg):
  from agents_tpu_torch.bandits.agents import RankingAgent
  from agents_tpu_torch.bandits.environments import (ClickModel,
                                                     FeedbackModel,
                                                     RankingBanditEnv)
  from agents_tpu_torch.bandits.networks.global_and_arm_feature_network \
      import make_global_and_arm_feature_network
  from agents_tpu_torch.bandits.specs.bandit_spec_utils import (
      create_per_arm_observation_spec)
  gdim, idim, items, slots = 3, 2, 8, 3
  w = np.random.default_rng(cfg.seed).normal(
      size=(idim, gdim)).astype(np.float32)
  env = RankingBanditEnv(
      global_sampling_fn=lambda draws, shape: draws.normal(
          "ranking_global", tuple(shape) + (gdim,)),
      item_sampling_fn=lambda draws, shape: draws.normal(
          "ranking_items", tuple(shape) + (idim,)),
      num_items=items, num_slots=slots, scores_weight_matrix=w,
      global_dim=gdim, item_dim=idim,
      feedback_model=FeedbackModel.SCORE_VECTOR,
      click_model=ClickModel.GHOST_ACTIONS, device=cfg.device)
  spec = create_per_arm_observation_spec(gdim, idim, items)
  net = make_global_and_arm_feature_network(spec, device=cfg.device,
                                            generator=_generator(cfg))
  from agents_tpu_torch.trajectories import time_step as ts
  return env, RankingAgent(ts.time_step_spec(spec), env.action_spec(), net,
                           _adam(cfg), slate_size=slots,
                           diversity_penalty=0.1, device=cfg.device)


SCENARIOS = {
    "linucb_stationary": _linucb_stationary,
    "lints_stationary": _lints_stationary,
    "neural_eps_greedy": _neural_eps_greedy,
    "neural_boltzmann": _neural_boltzmann,
    "neural_falcon": _neural_falcon,
    "neural_linucb": _neural_linucb,
    "dropout_ts": _dropout_ts,
    "bernoulli_ts": _bernoulli_ts,
    "exp3": _exp3,
    "exp3_mixture": _exp3_mixture,
    "wheel": _wheel,
    "drifting": _drifting,
    "piecewise": _piecewise,
    "movielens": _movielens,
    "per_arm": _per_arm,
    "ranking": _ranking,
}


def _supports(fn, env1, device):
  """Whether the env's `fn` (its optimal reward or action) is defined."""
  from agents_tpu_torch.specs import array_spec
  try:
    fn(array_spec.zero_spec_nest(env1.observation_spec(), outer_dims=(1,),
                                 device=device))
  except (NotImplementedError, AttributeError):
    return False
  return True


def build_loop(cfg: Config, scenario: str = "linucb_stationary"):
  """(loop, the scenario's single env, its metrics) of `scenario`."""
  from agents_tpu_torch.bandits.metrics import (RegretMetric,
                                                SuboptimalArmsMetric)
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.train import OnPolicyTrainLoop

  env1, agent = SCENARIOS[scenario](cfg)
  env = BatchedTorchEnv(env1, cfg.env_batch_size, device=cfg.device)
  metrics = []
  if _supports(env1.optimal_reward_fn, env1, env.device):
    metrics.append(RegretMetric(env1.optimal_reward_fn))
  if _supports(env1.optimal_action_fn, env1, env.device):
    metrics.append(SuboptimalArmsMetric(env1.optimal_action_fn))
  loop = OnPolicyTrainLoop(env, agent, tuple(metrics), rollout_length=2,
                           device=cfg.device)
  return loop, env1, tuple(metrics)


def train_eval(cfg: Config, scenario: str):
  """Runs `scenario` for `cfg.num_rounds` rounds; returns (loop state, the
  records written)."""
  loop, _, metrics = build_loop(cfg, scenario)
  state = loop.init(seed=cfg.seed)
  os.makedirs(cfg.root_dir, exist_ok=True)
  log_path = os.path.join(cfg.root_dir, f"{scenario}.jsonl")
  done, records = 0, []
  t0 = time.time()
  with open(log_path, "w") as f:
    while done < cfg.num_rounds:
      n = min(cfg.log_interval, cfg.num_rounds - done)
      # Fresh metric windows each interval, so the regret reflects the
      # current policy.
      state = dataclasses.replace(state, metric_states=tuple(
          m.init(cfg.env_batch_size, loop.device) for m in metrics))
      state, _ = loop.run(state, n)
      done += n
      results = {k: float(v) for k, v in loop.results(state).items()}
      rec = {"scenario": scenario, "round": done,
             "rounds_per_s": round(done * cfg.env_batch_size
                                   / (time.time() - t0), 1), **results}
      f.write(json.dumps(rec) + "\n")
      print(json.dumps(rec), flush=True)
      records.append(rec)
  return state, records


def main(argv):
  from examples.dqn_cartpole_torch import parse_args
  if "--list" in argv:
    print("\n".join(SCENARIOS))
    return
  scenario = "linucb_stationary"
  rest = []
  for a in argv:
    if a.startswith("--scenario="):
      scenario = a.split("=", 1)[1]
    else:
      rest.append(a)
  if scenario not in SCENARIOS:
    raise SystemExit(f"unknown scenario {scenario}; use --list")
  train_eval(parse_args(rest, Config(), smoke={}), scenario)


if __name__ == "__main__":
  main(sys.argv[1:])
