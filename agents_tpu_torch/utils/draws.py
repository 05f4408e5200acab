"""Sources of random draws.

The JAX package threads explicit PRNG keys; the port threads a draw source
instead. Every stochastic site asks the source for its draws by name, so a
run can take them from a `torch.Generator` on the device (`Draws`) or have
them replayed from a record (`ReplayDraws`): JAX's threefry and torch's
generators cannot agree, so the parity tests read the JAX package's draws
and replay them here, and the card-versus-CPU check replays one stream on
both devices. An exported policy draws from its program's inputs
(`InputDraws`), which hold gamma, beta and permutation draws as the raw
normals and uniforms that `marsaglia_tsang_gamma`, `beta_from_inputs`
and `permutation_from_keys` transform.

Sites:
  "env_reset"           uniform [B, 4] in [-0.05, 0.05)  (CartPole reset)
  "pixels_target"       randint [B] in [0, num_actions)  (SyntheticPixels
                                                          reset)
  "pixels_step_target"  randint [B] in [0, num_actions)  (SyntheticPixels
                                                          step)
  "catch_ball_col"      randint [B] in [0, columns)      (Catch reset)
  "pendulum_theta"      uniform [B] in [-pi, pi)         (Pendulum reset)
  "pendulum_theta_dot"  uniform [B] in [-1, 1)           (Pendulum reset)
  "actor_noise"         normal [B, *leaf shape]          (ActorPolicy
                                                          and PPOPolicy
                                                          sample, one
                                                          draw per action
                                                          leaf); for a
                        uniform [B, K] in [tiny, 1)      categorical leaf
                                                          of K actions,
                                                          which `Categorical.
                                                          sample` turns
                                                          into Gumbel noise
                                                          (jax.random.
                                                          categorical's
                                                          "low" mode)
  "sac_next_action_noise"
                        normal [S, *leaf shape]          (SAC critic
                                                          targets' next
                                                          actions)
  "sac_action_noise"    normal [S, *leaf shape]          (SAC actor loss's
                                                          actions)
  QtOpt's train step draws its CEM over the next time steps at
  "cem_normal" (and "cem_categorical") from the agent state's own source.
  "exploration_noise"   normal [B, *leaf shape]          (GaussianPolicy,
                                                          one per action
                                                          leaf)
  "ou_noise"            normal [B, *leaf shape]          (OUNoisePolicy,
                                                          one per action
                                                          leaf)
  "td3_target_noise"    normal [S, *action shape]        (TD3 target
                                                          policy smoothing)
  "cql_next_action_noise"
                        normal [S, *leaf shape]          (CQL-SAC critic
                                                          targets' next
                                                          actions)
  "cql_reward_noise"    normal [S]                       (CQL-SAC reward
                                                          noise, only with
                                                          a variance > 0)
  "cql_uniform_actions" uniform [n, S, *leaf] in [0, 1)  (CQL uniform
                                                          proposals, scaled
                                                          to the bounds)
  "cql_policy_noise"    normal [n, S, *leaf shape]       (CQL proposals
                                                          from the actor)
  "cql_action_noise"    normal [S, *leaf shape]          (CQL-SAC actor
                                                          loss's actions)
  "random_policy"       as `sample_spec` [B, *leaf]      (RandomPolicy)
  "random_action"       randint [B] in [0, num_actions)  (epsilon-greedy)
  "masked_random_action"
                        uniform [B, K] in [tiny, 1)      (epsilon-greedy's
                                                          random action
                                                          over a masked or
                                                          shifted Q policy:
                                                          Gumbel noise of a
                                                          uniform choice
                                                          among the valid
                                                          actions)
  "explore"             uniform [B] in [0, 1)            (epsilon-greedy
                                                          coin)
  "categorical"         uniform [*sample, B, K] in       (the default
                        [tiny, 1)                         `Policy._action`'s
                                                          sample of a
                                                          categorical leaf,
                                                          e.g. BoltzmannPolicy;
                                                          Gumbel noise)
  "cem_normal"          normal [N, B, *leaf shape]       (CEM samplers: one
                                                          per Gaussian leaf
                                                          per CEM iteration,
                                                          leaves in sorted-key
                                                          order)
  "cem_categorical"     uniform [N, B, K] in [tiny, 1)   (CEM one-hot
                                                          sampler: one per
                                                          one-hot leaf per
                                                          iteration; Gumbel
                                                          noise)
  "acrobot_physics"     uniform [B, 4] in [-0.1, 0.1)    (Acrobot reset)
  "mountain_car_position"
                        uniform [B] in [-0.6, -0.4)      (MountainCar and
                                                          ContinuousMountainCar
                                                          reset)
  "gumbel_softmax"      uniform [*sample, *logits] in    (GumbelSoftmax
                        [tiny, 1)                         sample)
  "bernoulli"           uniform [*sample, *logits]       (Bernoulli sample)
  "beta_gamma"          standard gamma [*sample, *batch] (Beta sample: the
                                                          concentration1
                                                          variates, then the
                                                          concentration0 ones)
  Bandit sites (`agents_tpu_torch.bandits`):
  "bandit_context"      uniform [B, d] in [low, high)    (stationary and
                                                          drifting bandit
                                                          contexts)
  "bandit_context_normal"
                        normal [B, d]                    (piecewise
                                                          linear-Gaussian
                                                          contexts)
  "random_bandit_context"
                        normal [B, d]                    (RandomBandit)
  "bandit_reward_noise" normal [B]                       (linear, wheel and
                                                          random bandit
                                                          rewards)
  "bandit_bernoulli"    uniform [B]                      (Bernoulli arm
                                                          rewards)
  "linear_reward_noise" normal [*batch]                  (the reward
                                                          callables of
                                                          environment_
                                                          utilities)
  "context_sampling"    randint [*batch, d]              (context_sampling_fn)
  "wheel_context"       uniform [R, B, 2] in [-1, 1)     (WheelBandit: R
                                                          candidate
                                                          contexts, the
                                                          first inside the
                                                          disk kept)
  "classification_index"
                        randint [B] in [0, N)            (dataset row)
  "mushroom_poison"     uniform [B]                      (mushroom reward
                                                          sampler)
  "movielens_user"      randint [B] in [0, num_users)    (MovieLens user)
  "movielens_movies"    uniform [B, num_movies]          (per-arm MovieLens:
                                                          each row's movies
                                                          in the order of
                                                          its uniforms)
  "action_mask"         uniform [B, K]                   (Bernoulli action
                                                          mask)
  "action_mask_fix"     randint [B] in [0, K)            (the arm enabled
                                                          in an all-zero
                                                          mask)
  "ranking_perturb"     normal [B, S + i]                (ranking click
                                                          model's score
                                                          noise)
  "ranking_choice"      uniform [B, S + i] in [tiny, 1)  (its click: Gumbel
                                                          noise)
  "ranking_click"       uniform [B, S]                   (positional-bias
                                                          clicks)
  "lints_eps"           normal [K, d]                    (linear Thompson
                                                          sampling: one per
                                                          call, shared by
                                                          every row)
  "bernoulli_ts_theta"  beta [B, K]                      (Bernoulli Thompson
                                                          sampling's
                                                          posterior draws,
                                                          replayed as the
                                                          beta variates
                                                          themselves)
  "dropout_keep"        uniform [B, width]               (dropout Thompson
                                                          sampling: a unit
                                                          is kept where its
                                                          uniform is below
                                                          1 - rate)
  "mixture_choice"      uniform [B, N] in [tiny, 1)      (mixture agents'
                                                          component: Gumbel
                                                          noise)
  "constraint_mask"     uniform [B, K]                   (constraints'
                                                          Bernoulli
                                                          feasibility mask)
  Epsilon-greedy bandit policies (constrained greedy, NeuralLinUCB's
  encoding phase) draw at "random_action" and "explore"; Falcon, Exp3 and
  Boltzmann sample at "categorical".
  "replay_t0"           randint [S] in [0, num_valid)    (window start
                                                          offset)
  "replay_rows"         randint [S] in [0, B)            (env row)
  "ppo_permutation"     permutation [n_items]            (PPO: one per
                                                          epoch, the
                                                          shuffle of the
                                                          flattened frames)
"""
from __future__ import annotations

import collections
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch


class Draws:
  """Draws from one `torch.Generator` on `device`."""

  def __init__(self, seed: int = 0, device="cuda"):
    self.device = torch.device(device)
    self.generator = torch.Generator(device=self.device)
    self.generator.manual_seed(int(seed))

  def uniform(self, site: str, shape, low: float = 0.0, high: float = 1.0,
              dtype=torch.float32) -> torch.Tensor:
    del site
    u = torch.rand(tuple(shape), generator=self.generator, device=self.device,
                   dtype=dtype)
    return u * (high - low) + low

  def randint(self, site: str, shape, low: int, high: int,
              dtype=torch.int64) -> torch.Tensor:
    del site
    return torch.randint(int(low), int(high), tuple(shape),
                         generator=self.generator, device=self.device,
                         dtype=dtype)

  def normal(self, site: str, shape, dtype=torch.float32) -> torch.Tensor:
    del site
    return torch.randn(tuple(shape), generator=self.generator,
                       device=self.device, dtype=dtype)

  def permutation(self, site: str, n: int) -> torch.Tensor:
    """A random permutation of range(n), int64, on the device."""
    del site
    return torch.randperm(int(n), generator=self.generator,
                          device=self.device)

  def gamma(self, site: str, concentration: torch.Tensor) -> torch.Tensor:
    """Standard-gamma variates of shape `concentration` (PyTorch's own
    sampler, the one `torch.distributions.Gamma` uses)."""
    del site
    a = concentration.to(device=self.device, dtype=torch.float32)
    return torch._standard_gamma(a, generator=self.generator)

  def beta(self, site: str, concentration1: torch.Tensor,
           concentration0: torch.Tensor) -> torch.Tensor:
    """Beta(concentration1, concentration0) variates of their broadcast
    shape, as x / (x + y) of two standard-gamma variates."""
    x = self.gamma(site, concentration1)
    y = self.gamma(site, concentration0)
    return x / (x + y)


class ReplayDraws:
  """Replays recorded draws, one queue per site, in the order recorded.

  Every record is moved to `device` when the source is built, so replaying
  copies nothing from the host. A draw whose shape differs from the
  record's, or a site whose queue ran dry, raises.
  """

  def __init__(self, records: Mapping[str, Sequence], device="cpu"):
    self.device = torch.device(device)
    self._queues: Dict[str, collections.deque] = {
        site: collections.deque(
            torch.from_numpy(np.array(v)).to(self.device) for v in values)
        for site, values in records.items()}

  def remaining(self) -> Dict[str, int]:
    return {site: len(q) for site, q in self._queues.items()}

  def _next(self, site: str, shape, dtype) -> torch.Tensor:
    queue = self._queues.get(site)
    if not queue:
      raise LookupError(f"no recorded draws left for site {site!r}")
    value = queue.popleft()
    if tuple(value.shape) != tuple(shape):
      raise ValueError(
          f"site {site!r}: recorded draw has shape {tuple(value.shape)}, "
          f"asked for {tuple(shape)}")
    return value.to(dtype)

  def uniform(self, site, shape, low=0.0, high=1.0, dtype=torch.float32):
    return self._next(site, shape, dtype)

  def randint(self, site, shape, low, high, dtype=torch.int64):
    return self._next(site, shape, dtype)

  def normal(self, site, shape, dtype=torch.float32):
    return self._next(site, shape, dtype)

  def permutation(self, site, n):
    return self._next(site, (n,), torch.int64)

  def gamma(self, site, concentration):
    return self._next(site, concentration.shape, concentration.dtype)

  def beta(self, site, concentration1, concentration0):
    return self._next(site, concentration1.shape, concentration1.dtype)


class RecordingDraws:
  """Passes draws through from `source` and keeps a CPU copy of each."""

  def __init__(self, source):
    self.source = source
    self.device = source.device
    self.records: Dict[str, List[np.ndarray]] = collections.defaultdict(list)

  def _keep(self, site, value):
    self.records[site].append(value.detach().cpu().numpy())
    return value

  def uniform(self, site, shape, low=0.0, high=1.0, dtype=torch.float32):
    return self._keep(site, self.source.uniform(site, shape, low, high, dtype))

  def randint(self, site, shape, low, high, dtype=torch.int64):
    return self._keep(site, self.source.randint(site, shape, low, high, dtype))

  def normal(self, site, shape, dtype=torch.float32):
    return self._keep(site, self.source.normal(site, shape, dtype))

  def permutation(self, site, n):
    return self._keep(site, self.source.permutation(site, n))

  def gamma(self, site, concentration):
    return self._keep(site, self.source.gamma(site, concentration))

  def beta(self, site, concentration1, concentration0):
    return self._keep(site, self.source.beta(site, concentration1,
                                             concentration0))


# Proposal rounds of `marsaglia_tsang_gamma`. Marsaglia and Tsang's
# method accepts a proposal with probability at least 0.951 for every
# alpha >= 1 (the boost below keeps it there for alpha < 1), so the chance
# that all GAMMA_ROUNDS proposals of a variate are rejected is at most
# 0.049**10 < 8e-14, under 1e-12.
GAMMA_ROUNDS = 10


def gamma_input_shape(shape, rounds: int = GAMMA_ROUNDS) -> tuple:
  """Shape of `marsaglia_tsang_gamma`'s inputs for variates of `shape`."""
  return (2 * rounds + 1,) + tuple(shape)


def marsaglia_tsang_gamma(concentration: torch.Tensor, inputs: torch.Tensor,
                          rounds: int = GAMMA_ROUNDS) -> torch.Tensor:
  """Standard-gamma variates of `concentration`'s shape from pre-drawn
  inputs, by Marsaglia and Tsang's method (ACM TOMS 26(3), 2000) with a
  fixed number of rounds, so a program (an export) can compute it.

  `inputs` is ``[2R + 1, *shape]`` float: rows 0..R-1 unit normals x, rows
  R..2R-1 uniforms u in [0, 1) for the acceptance tests, row 2R a uniform
  for the boost. For alpha < 1 the method runs at alpha + 1 and the
  variate is multiplied by ``U ** (1 / alpha)`` (the boost). With ``d =
  alpha - 1/3``, ``c = 1 / sqrt(9 d)`` and ``v = (1 + c x)**3``, round r
  accepts where ``v > 0`` and ``log u < x**2 / 2 + d - d v + d log v``;
  each element takes the first round that accepts, and the variate is
  ``d v``. Where no round accepts (probability below 1e-12, see
  GAMMA_ROUNDS), the last round's proposal is taken, its v clamped at the
  smallest positive float.
  """
  a = concentration
  boost = a < 1
  alpha = torch.where(boost, a + 1, a)
  d = alpha - 1.0 / 3.0
  c = torch.rsqrt(9.0 * d)
  x, u, u_boost = inputs[:rounds], inputs[rounds:2 * rounds], inputs[-1]
  v = (1.0 + c * x) ** 3
  positive = v > 0
  safe_v = torch.where(positive, v, torch.ones_like(v))
  accept = positive & (torch.log(u) < 0.5 * x * x + d - d * safe_v
                       + d * torch.log(safe_v))
  # The first accepting round: the count of rounds before it, and the last
  # round where none accepts.
  first = torch.clamp(
      (torch.cumsum(accept.to(torch.int32), 0) == 0).sum(0), max=rounds - 1)
  chosen = torch.gather(v, 0, first.unsqueeze(0)).squeeze(0)
  g = d * torch.clamp(chosen, min=torch.finfo(v.dtype).tiny)
  return torch.where(boost, g * torch.exp(torch.log(u_boost) / a), g)


def beta_from_inputs(concentration1: torch.Tensor,
                     concentration0: torch.Tensor, inputs: torch.Tensor,
                     rounds: int = GAMMA_ROUNDS) -> torch.Tensor:
  """Beta variates ``x / (x + y)`` of two `marsaglia_tsang_gamma`
  variates, x of `concentration1` from ``inputs[0]`` and y of
  `concentration0` from ``inputs[1]``."""
  x = marsaglia_tsang_gamma(concentration1, inputs[0], rounds)
  y = marsaglia_tsang_gamma(concentration0, inputs[1], rounds)
  return x / (x + y)


def permutation_from_keys(keys: torch.Tensor) -> torch.Tensor:
  """The permutation that sorts `n` uniform keys (a stable argsort)."""
  return torch.argsort(keys, stable=True)


class InputDraws:
  """Draws taken, in order, from pre-drawn inputs: one input per entry of
  `sites` (an exported policy's manifest ``draw_sites``), whose kind and
  site each call must match. Uniform, randint and normal inputs are the
  draws themselves; a gamma input goes through `marsaglia_tsang_gamma`, a
  beta input through `beta_from_inputs`, a permutation's uniform keys
  through `permutation_from_keys`. An exported program draws through one
  of these, so the eager policy over the same inputs acts as the program
  does."""

  def __init__(self, sites, inputs, device):
    self._items = iter(zip(sites, inputs))
    self.device = torch.device(device)

  def _next(self, kind, site):
    expected, value = next(self._items)
    if (expected["kind"], expected["site"]) != (kind, site):
      raise RuntimeError(f"draw {kind}@{site} where the trace drew "
                         f"{expected['kind']}@{expected['site']}")
    return expected, value

  def uniform(self, site, shape, low=0.0, high=1.0, dtype=torch.float32):
    return self._next("uniform", site)[1]

  def randint(self, site, shape, low, high, dtype=torch.int64):
    return self._next("randint", site)[1]

  def normal(self, site, shape, dtype=torch.float32):
    return self._next("normal", site)[1]

  def permutation(self, site, n):
    return permutation_from_keys(self._next("permutation", site)[1])

  def gamma(self, site, concentration):
    expected, value = self._next("gamma", site)
    return marsaglia_tsang_gamma(concentration, value, expected["rounds"])

  def beta(self, site, concentration1, concentration0):
    expected, value = self._next("beta", site)
    return beta_from_inputs(concentration1, concentration0, value,
                            expected["rounds"])


def as_draws(seed_or_draws, device):
  """A draw source: `seed_or_draws` itself, or `Draws(seed, device)`."""
  if isinstance(seed_or_draws, (int, np.integer)):
    return Draws(int(seed_or_draws), device)
  return seed_or_draws
