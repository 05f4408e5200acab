#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs one
card, imports nothing of JAX or `agents_tpu`, and exits non-zero when
`torch.cuda.is_available()` is false. It checks; it does not measure the
port's speed, which `python3 portbench/run.py` measures. Each phase prints
one JSON line with its wall time since the line before (`phase_seconds`);
any failed phase exits non-zero before the last line. A "sync-checked"
stretch runs under ``torch.cuda.set_sync_debug_mode("error")``, which
fails on any host sync; each crosses every periodic branch of its loop
that the stretch reaches (a target update, the end of a training phase).
The phases run in the order below, except the six long learning runs and
five phases that run beside them: `sac_learn` runs after every other
phase of this process (the host phases 34-39b, the replay phases 40-44,
`bench` and `lstm_kernel` included), while `td3_learn`, `cql_offline` with
`bc`, `qtopt_learn`, `ppo_rnn_learn`, `per_learn` and part (c) of
`surface` (line `surface_bernoulli_ts`) run beside it in six child
processes of this script (``chip_smoke.py --child NAME``) on the same
card; after `sac_learn`, while the children finish, this process runs
`bandit_learn`, `bandit_scenarios`, `discrete_parity`, `rnn_parity` and
`parallel_env`, whose gates are exact or learning bars that repeat bit
for bit.

  1. device       torch/CUDA versions, the card's name and power limit.
  2. parity       5 fused iterations at B=64, MLP (100, 50) on "cpu" and on
                  "cuda" from one set of numpy-made params and one replayed
                  stream of draws (TF32 off): losses, params, target params,
                  replay storage and metrics agree (floats rtol 1e-5 /
                  atol 1e-6; ints and step types exactly).
  3. main         the CartPole bench operating point (B=4096 env rows, ring
                  512, sample 256, MLP (100, 50), eps 0.1, gamma 0.99, tau
                  0.05 every 5, Adam 1e-3): init with 100 collect steps,
                  50 warm-up iterations, then 10 sync-checked ones (two
                  target updates); tensors on the card, finite losses,
                  exact replay count, legal step-type transitions; then one
                  iteration traced through the port's `profiling.trace`
                  inside `profiling.annotate` spans (the window, and the
                  loop's `run` decorated) that must appear in the trace.
  4. learn        the same run continued to 6000 iterations; the last-20
                  AverageReturn must reach 195 (`DQN_CARTPOLE_REFERENCE_LIVE`;
                  the bars come from the port's copy of the windows).
  5. eval         greedy `evaluate` over exactly 30 episodes.
  5a. learner_export  the trained state into the port's `Learner` under a
                  temporary root_dir (checkpoints, summaries through
                  `MultiWriter(JsonlSummaryWriter, TensorBoardEventWriter)`
                  and a `PolicyCheckpointTrigger` every 500) for 1,000
                  iterations: a finite loss, checkpoints at 500 and 1,000;
                  the events file read back by the script's own reader
                  (TFRecord framing, masked CRC-32C, every scalar equal to
                  its JSONL line); a fresh loop and Learner on the
                  directory resume at 1,000 bit for bit; the greedy
                  artifact batch-polymorphic with its policy config, its
                  `loader.py` in a child that imports numpy and torch only
                  acting on the 4,096 rows' observations on "cuda" and
                  "cpu" as the live greedy policy does (rows whose top two
                  Q values lie within 1e-5 excepted), twice more on
                  "cuda", where both calls replay the program's CUDA graph
                  and act as the first call did, and on one row on
                  "cuda"; `load_policy(dir)` alone scores at least the
                  `eval` bar over exactly 30 episodes.
  5b. eval_job    `examples/eval_job_torch.py`'s loop in a child
                  (``chip_smoke.py --eval-job ROOT``) over random envs with
                  CartPole's specs: it evaluates the export, the parent
                  refreshes its params at a higher train step, and the
                  child evaluates again and exits 0; both train steps as
                  written.
  5c. data_parallel  (a) the bench point (B=4096, ring 512, sample 256,
                  (100, 50), 100 collect steps) through `FusedTrainLoop(
                  mesh=)` over a one-rank NCCL group: 20 warm-up
                  iterations, whether one more is sync-free, then 10 (two
                  target updates) with finite losses, their collective
                  bytes and calls per iteration printed; (b) two gloo ranks
                  on the card (`torch_dryrun.spawn_ranks`), 2,048 rows
                  each, 3 iterations of the fused DQN loop, of PER (alpha
                  0.6, beta 0.4) and of sharded PPO
                  (`examples/ppo_cartpole.py`'s config, 2 minibatch
                  shards), each drawing from its own seeded generator; then
                  one process over the global batch replaying the ranks'
                  draws (PER sampled as 2 equal-mass shards): networks,
                  Adam moments, normalizers, metric deques, replay rows and
                  priorities per tensor to max|d| <= 1e-5 + 1e-4 max|ref|,
                  integers exactly, replicated tensors bit-equal across
                  ranks, finite losses, and the bytes each iteration passes
                  to `torch.distributed` under the gradient's bytes per
                  optimizer step plus the optimizer state's plus the metric
                  traffic, and no collective but the gradient's all-reduce
                  (largest: the gradient's size) and the metric rows'
                  all-gathers (at most 2 per row). PPO's whole run is held
                  against a witness, the one process with every linear
                  layer computed in the ranks' row blocks (the same values
                  up to the GEMMs' rounding), and against the plain one
                  process for its first 2 iterations; each iteration also
                  from the ranks' state before it; per iteration, where the
                  clipped surrogate's ratios part and which items change
                  sides of the clip is printed. Which of gloo's
                  collectives take CUDA tensors directly is probed and
                  printed. (c) The fourth path, LinUCB's statistics summed
                  over the ranks (`torch_dryrun.run_bandit`, the twin of
                  `_dryrun_bandit_psum`): the bandit example's d=8, K=5
                  agent trained on each rank's 128 of 256 rows for 3
                  calls, against one process over all rows: A, b, n per
                  tensor to the rule above, bit-equal across ranks, and
                  per train call exactly one all-reduce of (K d^2 + K d +
                  K) float32.
  5d. bandit_parity  `examples/bandits_train_eval_torch.py` at its default
                  config (B=256, d=8, K=5) for `linucb_stationary`,
                  `lints_stationary`, `neural_eps_greedy`, `neural_linucb`
                  and `ranking`: 98 rounds on "cpu" drawing from a recorded
                  generator, then 4 more (straddling the end of
                  NeuralLinUCB's encoding phase), each repeated on the card
                  from the CPU's state before it with the CPU's draws
                  (TF32 off).
                  The collected rounds' first actions equal wherever the
                  top two scores of the CPU's decision lie more than
                  1e-5 max|score| apart (the ranking slate: at each of its
                  picks), contexts, rewards, rounds and step types equal
                  (floats rtol 1e-5 / atol 1e-6) on the rows whose actions
                  agree, the metrics when all agree; the card's train step
                  on the CPU's round from the CPU's state gives its loss,
                  networks, Adam moments and A, b, n (rtol 1e-5 / atol
                  1e-6).
  5e. bandit_main the same five scenarios at B=256: 10 warm-up rounds, then
                  100 sync-checked ones (past NeuralLinUCB's 100-step
                  encoding phase); finite losses and metrics, the train
                  step counted.
  5f. bandit_learn  `linucb_stationary` and `neural_eps_greedy` through the
                  example's `train_eval` for its 1,000 rounds (seed 0):
                  the last 200-round window's regret and suboptimal-arm
                  share at or below the JAX package's bars
                  (`BANDIT_LEARN_BARS`, its runs over seeds 0-4).
  5g. bandit_scenarios  each of the example's 16 scenarios through
                  `train_eval` for 20 rounds (windows of 10): finite
                  metrics, the JSONL written.
  5h. surface     the public surface the JAX package has beyond the paths
                  above: (a) and (b) run after `bandit_main`; (c) in a
                  child beside the learning runs (its own line,
                  `surface_bernoulli_ts`). (a) The CartPole bench point
                  through `FusedTrainLoop` with `UniformReplay(
                  sort_for_locality=True)`: 20 warm-up and 10 sync-checked
                  iterations (two target updates) with finite losses; a
                  2-step sample of 256 from the sorted ring equal on "cpu"
                  under the card's recorded draws (ids, rows and windows
                  exactly, ids*B + rows in order). (b) On "cuda" against
                  "cpu" (TF32 off; floats rtol 1e-5 / atol 1e-6, integers
                  equal): `index_with_actions(multi_dim_actions=True)` over
                  [4096, 6, 5] Q values; `ActorPolicy(
                  emit_log_probability=True)` at the SAC bench point's
                  actor ((256, 256), B=32) on Pendulum observations, the
                  actions and the log-probabilities of the rows whose
                  log-probability a 1e-6 relative move of the action moves
                  by less than the tolerance (at least a third);
                  `StreamingTensorNormalizer.update(outer_dims=(0, 1))`
                  over [4096, 8, 3] three times; `pack_rows` /
                  `unpack_rows` on 256 Atari rows of 28,224 uint8. (c)
                  Bernoulli Thompson sampling at the example's scenario
                  (`BernoulliBandit([0.3, 0.5, 0.7, 0.65])`, B=256) trained
                  200 rounds, saved by `PolicySaver` with "cpu" and "cuda"
                  programs, the posterior restored by `load_policy`; the
                  artifact in a child that imports numpy and torch only
                  acts on both platforms as the live policy drawing
                  through `InputDraws` over the loader's inputs (0 of 256
                  apart); the Marsaglia-Tsang gamma transform on the card
                  at alpha 0.5, 1, 5 and 50 (100,000 variates each from
                  numpy draws, seed 14) passes a KS test against
                  `scipy.stats.gamma` at p > 1e-3.
  6. conv_parity  (a) `examples/dqn_pixels_torch.py`'s loop on
                  SyntheticPixels 20x20x4, mnih15 torso, fp32 (TF32 off,
                  deterministic cuDNN), B=8, ring 64, sample 16: 3 fused
                  iterations on "cpu" and "cuda" from numpy-made params and
                  one replayed draw stream agree (floats rtol 1e-4 / atol
                  1e-5; uint8 frames, actions and step types exactly).
                  (b) the bfloat16 bench network on 32 frames of 84x84x4:
                  Q values within atol 1e-2, greedy actions equal wherever
                  the top-two gap exceeds 1e-2.
  7. conv_main    the pixel bench point (``bench.py:conv_bench``: B=128,
                  sample 256, ring 2048 of uint8 84x84x4 frames, mnih15 +
                  fc 512 in bfloat16): 64 collect steps, 20 warm-up and 10
                  sync-checked iterations (the target update comes every
                  500 train steps); the same checks as phase 3 plus the
                  observation ring's dtype and bytes.
  8. conv_learn   the example's ``--env=catch`` config: up to 2,400
                  iterations to a last-100 AverageReturn above 0.3, then
                  greedy `evaluate` over exactly 30 episodes.
  9. c51          C51 (51 atoms on [-10, 10]) at the pixel bench point: 10
                  warm-up and 10 sync-checked iterations, finite losses,
                  the exact replay count.
 10. sac_parity   `examples/sac_pendulum_torch.py`'s loop at the SAC width
                  ((256, 256) actor and critics) on the device Pendulum,
                  B=8, ring 64, sample 32, 2 train steps per iteration:
                  16 collect steps then 3 fused iterations on "cpu" and
                  "cuda" from numpy-made params and one replayed stream of
                  draws (TF32 off): losses, the five networks, log alpha,
                  the three Adams' moments, replay storage and metrics
                  agree (floats rtol 1e-5 / atol 1e-5; step types exactly).
 11. sac_main     the SAC bench point (``bench.py:sac_live_probe``'s agent
                  and replay on the device Pendulum: B=32, ring 4096,
                  sample 256, (256, 256), Adam 3e-4 x3, tau 0.005, gamma
                  0.99, reward scale 0.1, UTD 1.0 = 32 train steps per
                  iteration, 64 collect steps): 2 warm-up iterations and 1
                  sync-checked one (32 train steps; the target update
                  comes every step); exact replay count and train steps,
                  finite losses and log alpha, legal step types, tensors on
                  the card.
 12. sac_learn    the example's ``--preset=live`` config (B=8, ring 8192,
                  sample 256, 4 train steps, (64, 64)): up to 8,000
                  iterations, checked every 250, to a last-20 AverageReturn
                  of -250 or more, then greedy `evaluate` over exactly 30
                  episodes.
 13. ppo_parity   the PPO learner, card against CPU on the CPU's rollouts
                  (TF32 off): `examples/ppo_cartpole_torch.py`'s CartPole
                  loop (B=32, T=128, 10 epochs x 8 minibatches, (64, 64))
                  for 2 iterations, and its schulman17 preset cut to
                  T=257 and 4 minibatches for 1, from numpy-made trees.
                  On each CPU rollout the card's policy outputs, then its
                  train step on a copy with the CPU's permutations: losses,
                  networks, Adam moments, normalizers, beta and learning
                  rate agree, each tensor to max|card - cpu| <= 1e-5 +
                  1e-4 * max|cpu| (the Adam moments 1e-5 + 1e-3 *
                  max|cpu|).
 14. ppo_main     the PPO CartPole point (`examples/ppo_cartpole.py`'s
                  config): 2 warm-up and 12 sync-checked iterations, then a
                  15th collected and trained apart; tensors on the card,
                  finite losses, legal step types in that rollout, the
                  train step counted.
 15. ppo_learn    the same loop continued from its 15th iteration, checked
                  every 10 iterations, to a last-20 AverageReturn of 195
                  within 150 iterations (`PPO_CARTPOLE_LIVE` of the port's
                  copy of the windows,
                  ``agents_tpu_torch/benchmark/return_windows.py``), then
                  greedy eval over exactly 30 episodes on 10 fresh rows.
 16. ppo_schulman17  the example's --preset=schulman17_pendulum (B=1,
                  T=2049, 10 x 32 minibatches of 64, tanh, std 0.35, Adam
                  eps 1e-5 decayed linearly, clipping 0.5): 1 warm-up and 1
                  sync-checked iteration; finite losses, tensors on the
                  card, the learning rate decayed to its value after 2
                  iterations.
 17. reinforce    REINFORCE with a (64, 64) value baseline on CartPole,
                  B=32, T=128: 1 warm-up and 1 sync-checked iteration,
                  finite losses, tensors on the card.
 18. td3_parity   `examples/td3_pendulum_torch.py`'s loop on the device
                  Pendulum at B=8, ring 64, sample 32, 2 train steps,
                  (64, 64): 16 collect steps then 5 fused iterations on
                  "cpu" and "cuda" from numpy-made params and one replayed
                  stream of draws (TF32 off), for TD3 (Gaussian exploration,
                  the actor every 2nd step), DDPG (OU exploration) and DDPG
                  with dQ/da clipped at 0.5: losses, every network, both
                  Adams' moments, replay storage and metrics agree (floats
                  rtol 1e-5 / atol 1e-5; step types exactly).
 19. td3_main     the TD3 bench point (the example's defaults: B=32, ring
                  4096, sample 256, (256, 256), 32 train steps per
                  iteration, 64 collect steps): 2 warm-up iterations and 1
                  sync-checked one (32 train steps: 16 actor steps, a target
                  update each step); the checks of phase 11 and the actor's
                  Adam steps; then DDPG at the same point, its OU state in
                  the driver, 1 warm-up and 1 sync-checked iteration:
                  finite losses, the OU state on the card and moving.
 20. td3_learn    the example's --preset=live (B=8, ring 8192, sample 256, 4
                  train steps, (64, 64)): up to 8,000 iterations, checked
                  every 250, to a last-20 return of -250 or more (the JAX
                  package's TD3 passes it at 3,500-7,000 over five seeds),
                  then greedy eval over exactly 30 episodes.
 21. cql_parity   `CqlSacAgent.train` for 3 steps on three fixed numpy-made
                  batches of 256 from numpy-made params on "cpu" and "cuda",
                  the card replaying the CPU's draws (TF32 off): the
                  offline example's agent (temperature 50, 8 samples) and
                  the kumar20 preset's (256, 256, 256) critics with
                  CQL-Lagrange, each with 1 BC step; losses, the CQL term
                  and weight, every network and the four Adams' moments,
                  each tensor to max|card - cpu| <= 1e-5 + 1e-4 max|cpu|.
 22. cql_main     the kumar20 preset's train step (10 samples: 2 critics x
                  21 Q passes of 256 rows, (256, 256, 256) critics, (256,
                  256) actor) over a ring of 32 rows x 4,096 Pendulum frames
                  filled by `RandomPolicy`: 10 sync-checked steps of the BC
                  phase, then 10 past it (the target update comes every
                  step); a finite loss and log alpha, tensors on the card,
                  the ring's count, the train step counted.
 23. cql_offline  `examples/cql_sac_offline_torch.py`'s defaults end to end
                  with the dataset in a temporary directory: the SAC
                  behaviour policy (greedy return > -1,000), the npz round
                  trip, 1,000 BC steps (greedy return > -500) and 3,000
                  CQL steps in all (> -700), the bars of
                  ``tests/test_cql_offline_e2e.py:66, :147, :151``.
 24. bc           `--agent=bc` on the same dataset: 3,000 steps, then the
                  greedy return over exactly 30 episodes as a D4RL
                  normalized score, 0 at `RandomPolicy` and 1 at the
                  behaviour policy's greedy return (each over the same 30
                  episodes): at least 0.8 (the JAX package's BC at this
                  config scores 0.922 to 0.993 over four seeds,
                  `tests/test_torch_reference_bars.py`).
 25. qtopt_parity QtOpt card against CPU from a numpy-made (256, 256)
                  critic, TF32 off, the card replaying the CPU's draws:
                  (a) `CEMPolicy.optimize` (32 samples, 4 elites, 3
                  iterations) at B=256: equal elites on every row whose
                  E-th and (E+1)-th Q lie more than 1e-5 of max|Q| apart,
                  and the actions and Q values of the rows clear at every
                  iteration; (b) 3 `QtOptAgent.train` steps at sample 256,
                  each from the CPU's state before it; (c) the
                  epsilon-greedy-over-CEM collect policy's actions on the
                  CPU's time steps. Each tensor to max|card - cpu| <= 1e-5
                  + 1e-4 max|cpu|.
 26. qtopt_main   the QtOpt bench point (`--agent=qtopt` at the example's
                  defaults: B=32, ring 4096, sample 256, (256, 256) critic,
                  Adam 3e-4, 32 train steps per iteration, 64 collect
                  steps): 2 warm-up iterations and 1 sync-checked one (32
                  train steps, CEM in each; the delayed critics copied
                  every 5th); the checks of phase 11 but log alpha.
 27. discrete_parity  card against CPU, each step from the CPU's state:
                  Acrobot, MountainCar and ContinuousMountainCar for 200
                  steps of random actions over auto-resets (B=64); 3 fused
                  iterations of Boltzmann-collect DQN on Acrobot; a masked
                  `QPolicy` (a splitter over a [B, 6 + 3] observation), a
                  shifted one (actions 1-3) and epsilon-greedy over each,
                  exploration inside the mask and the shift.
 28. qtopt_learn  `--agent=qtopt --preset=live` (B=8, ring 8192, sample 256,
                  4 train steps, (64, 64) critic): up to 8,000 iterations,
                  checked every 250, to a last-20 return of -250 or more
                  (the JAX package's QtOpt passes it at 1,750-3,500 over
                  five seeds, `tests/test_torch_reference_bars.py`), then
                  greedy eval over exactly 30 episodes; a third child
                  process beside `td3_learn` and `cql_offline`.
 29. rnn_parity   card against CPU (TF32 off) from numpy-made flax-shaped
                  trees at the RNN factories' widths (input (40,), LSTM 40,
                  output (40,)): (a) the Q, value and actor RNNs at B=64,
                  one step and [B, 16] sequences with FIRST steps scattered,
                  from a zero and a non-zero carry; (b) 3 recurrent DDQN
                  train steps at sample 256 x T=10, each from the CPU's
                  state; (c) one recurrent PPO iteration of
                  ``examples/ppo_cartpole_torch.py --preset=rnn``, the card
                  unrolling its networks over the CPU's rollout and
                  training on it with the CPU's permutations. Each tensor
                  to max|card - cpu| <= 1e-5 + 1e-4 max|cpu|; every forward
                  step of a card unroll ran the LSTM kernel
                  (`lstm.kernel_steps` against the steps routed to the
                  card) and every CPU one the plain loop.
 30. rnn_dqn_main the CartPole bench point (B=4096, ring 512, sample 256)
                  with `make_q_rnn_network` at its defaults, `DdqnAgent`
                  and sequences of 10: 5 warm-up iterations, 10
                  sync-checked ones (two target updates) with the checks of
                  phase 3 and the carry's shapes, and 5 traced. The LSTM
                  kernel's launches over the traced iterations, per
                  iteration and per unroll: one a forward or backward step
                  and one a backward's start (against the `lstm.steps`,
                  `lstm.backward_steps` counters and the `lstm.backward`
                  span), every step on the kernel, the same per iteration
                  as over the sync-checked ones, and the trace's kernels on
                  the card by name (each function launched shows, none more
                  often).
 31. ppo_rnn_main ``--preset=rnn`` (B=32, T=128, 10 epochs x 8 minibatches of
                  4 sequences, Adam 3e-4, LSTM actor and value at the
                  factories' defaults): 1 warm-up and 1 sync-checked
                  iteration, the LSTM kernel's launches over it checked as
                  in `rnn_dqn_main` (without a trace); tensors on the card,
                  finite losses, the carry's shapes, legal step types in
                  one more rollout.
 32. checkpoint_resume  save, rebuild from the seed, restore and continue,
                  `torch.equal` to the run without a break in the losses
                  and every tensor, number and generator state: (a) fused
                  DQN at the CartPole bench point, 50 + 50 iterations; (b)
                  ``--preset=rnn_learn`` PPO, 3 + 3, the LSTM carry and the
                  episodes in flight; (c) SAC at the `sac_parity` config,
                  3 + 3, its three Adams and log alpha; (d) the PER loop
                  at the bench point, 50 + 50, its priorities, max
                  priority and host count.
 33. ppo_rnn_learn  ``--preset=rnn_learn`` (``tests/test_ppo_rnn.py``'s
                  config: B=8, T=48, (32,) / 16 / (32,), 4 epochs x 2
                  minibatches, entropy 0.01, Adam 1e-3) for 30 iterations
                  to a last-20 return above 83 (the JAX test's 35,
                  tightened to the JAX package's own runs over five seeds,
                  `tests/test_torch_reference_bars.py`), then greedy eval
                  over exactly 30 episodes; the LSTM kernel's launches over
                  the training, checked as in `rnn_dqn_main`; a fourth child
                  process.
 34. host_parity  `HostDeviceTrainLoop` with SAC at (256, 256) over a
                  `BatchedPyEnvironment` of 8 seeded `RandomPyEnvironment`s
                  with HalfCheetah-v5's specs (observation (17,), action
                  (6,) in [-1, 1]), ring 64, sample 32, 2 train steps per
                  tick: 4 random ticks then 3 ticks on "cpu" and "cuda" from
                  numpy-made params and one replayed stream of draws (TF32
                  off): the loss, the five networks, log alpha, the Adams'
                  moments, the replay storage, the actions and time steps
                  agree (rtol 1e-5 / atol 1e-5); py-metric results and step
                  types equal.
 35. host_sac_main  the sync host loop at `bench.py:sac_live_probe`'s point
                  (`examples/sac_halfcheetah_torch.py`'s agent and replay:
                  B=32 random HalfCheetahs on a thread pool, ring 4096,
                  sample 256, 32 train steps per tick, (256, 256), reward
                  scale 0.1; 64 random ticks, 2 warm-up ticks): over 2
                  ticks under ``set_sync_debug_mode("warn")`` the port
                  syncs once a tick (the action read) besides the loss
                  read; a finite loss and log alpha, tensors on the card,
                  the replay count, train steps and env steps exact.
 36. async_sac_main  `bench_torch.py:sac_live_probe`: `AsyncHostDeviceTrainLoop`
                  at that point (UTD 1.0, `min_replay_frames` 64 B, 32 train
                  steps per call), one ramp run of 256 ticks, then 1,200
                  timed ticks (the probe's minimum): env-steps/s,
                  train-steps/s, the realized UTD over the trainable window
                  (``bench.py:102-106``), the collector's median tick with
                  and without a train call in flight; gates on the probe's
                  checks (the trainer's drain, exact env steps, train steps
                  <= UTD x env steps + 32, a finite loss), not on the UTD.
                  It runs `bench_torch.py`'s own code and still prints its
                  rates.
 37. host_ppo_main  `HostOnPolicyTrainLoop` at `examples/ppo_halfcheetah.py`'s
                  schulman17 config (B=1, T=2049, (64, 64) tanh, 10 x 32
                  minibatches, clip 0.2, gradient clipping 0.5) over a random
                  HalfCheetah: 1 warm-up iteration and 1 whose collect's
                  host syncs are counted; finite losses, the train step, the
                  rollout [1, 2049] on the card.
 38. parallel_env `ParallelPyEnvironment` of 4 random HalfCheetah workers
                  started after CUDA is initialized (so by spawn), overlapped
                  and blocking: 50 steps equal a `BatchedPyEnvironment` of
                  the same seeds exactly; no worker outlives `close`.
 39. async_resume the async loop (B=8, ring 256, 4 train steps per call) for
                  60 ticks with checkpoints every 25 and at the end, then a
                  fresh loop object resumed toward 90: the restored state
                  `torch.equal` to the saved one, counters and metrics
                  continued.
 39a. atari_host  `examples/dqn_atari_torch.py`'s `train_eval` at its Config
                  (B=8, a ring of 1,000,000 uint8 84x84x4 frames: 28.2 GB on
                  the card, mnih15 + fc 512 in fp32, sample 32, 8 train steps
                  per call, UTD 0.25, Adam 2.5e-4 eps 0.01) over 8 random
                  envs with the repaired `load_atari` specs (Pong's 6
                  actions, 500-step episodes), cut to 1,000 ticks, 500 of
                  them random: the trainer drained, env steps exact, train
                  steps <= 0.25 (env steps - min frames) + 8, every loss
                  finite, epsilon at the last train step equal to
                  `epsilon_fn`, on the collector over the run exactly one
                  sync per policy tick (the action read) and one per tensor
                  of a fresh agent state (the run's copy of the initial
                  networks) and no other, the ring's dtype and bytes,
                  the exported greedy program acting on 256 ring frames in a
                  numpy-and-torch-only child on "cuda" and "cpu" as the live
                  policy (rows within 1e-5 of a tie excepted).
 39b. offline_host  `examples/cql_sac_offline_host_torch.py`'s `train_eval`
                  ("mixed") at its Config (B=32, actor (256, 256), critic
                  (256, 256, 256), sample 256, 10 CQL samples, alpha 5.0, 64
                  train steps per call, 10 eval envs) over random
                  HalfCheetah-spec envs, each phase cut (16,384 behaviour
                  env steps, 16,384 dataset frames, 96 BC of 192 offline
                  steps, an eval at 128), then phase C
                  again through `reuse_phase_ab`: the frames collected on
                  disk and in both rings, every loss finite, 3 snapshots,
                  both phase Cs equal bit for bit
                  (every loss, the final params), no sync inside a phase-C
                  train call, eval episodes exact, the export acting as the
                  live policy (the state after the last train call) in a
                  bare child (rtol 1e-5 / atol 1e-5).
 40. per_parity   the PER fused DQN loop (B=64, ring 64, sample 32, (100, 50),
                  alpha 0.6, beta 0.4, TF32 off), card against CPU for 5
                  iterations, each from the CPU's state with the CPU's
                  draws: ids and rows equal on every sample whose uniform
                  lies more than 4 ulp of the total from a CDF boundary; on
                  each iteration whose samples all agree (at least 3 of 5),
                  probabilities, IS weights, loss, priorities, max priority
                  and networks at rtol 1e-5 / atol 1e-6.
 41. per_main     PER at the CartPole bench point (B=4096, ring 512: 2,097,152
                  priorities; sample 256; (100, 50)): 100 collect steps, 20
                  warm-up and 10 sync-checked iterations (two target
                  updates); exact replay count, finite losses, IS weights
                  in (0, 1], priorities finite and spread.
 42. episodic     `EpisodicReplay` (B=64 CartPole rows, 256 slots of 64) for
                  300 `add_batch` calls on "cpu" and "cuda" with the same
                  frames: slots, lengths, ids, cursor and completed ids
                  equal at every call, the card's calls and samples free of
                  syncs but for the callback drains (every 50 calls), the
                  sampled episodes equal from the CPU's draws.
 43. ingest_sac   `examples/sac_train_job_torch.py`'s learner at the JAX job's
                  defaults (rings of 32,768, replay 256 rows x 512, sample
                  256, 8 train steps per call, min 512 items, SAC (256, 256))
                  fed by two collector processes (``chip_smoke.py
                  --collector``, the collect job on the CPU, B=8 random
                  envs with Pendulum-v1's specs, rewards tagging each
                  frame), weights through the shm store every 200 steps;
                  a `MinSize` and a `SampleToInsertRatio` (8) leg of 400
                  train steps: every pushed frame drained once with equal
                  bytes, no sample before 512 items, the ratio inside its
                  error buffer, each collector's pulled steps advancing and
                  untorn (CRC), no sync inside a train call, the learner's
                  `PolicySaver` exports (collect and greedy, "cpu" and
                  "cuda" programs) at each publish's step, advancing.
 44. host_replay  `bench_torch.py:host_atari_replay_probe`:
                  `PyUniformReplayBuffer` and `PyHashedReplayBuffer` (84x84x4
                  uint8, capacity cut from 1M frames to 100k): fill
                  frames/s, 2-step samples at batch 256, the batch's H2D
                  GB/s, the hashed variant's add rate and bytes stored;
                  gates on the probe's checks (every frame held, sampled
                  windows of consecutive stored frames in both buffers, the
                  copy equal, 1,024 unique hashed frames, equal samples).
                  It runs `bench_torch.py`'s own code and still prints its
                  rates.
 44a. bench      ``bench_torch.py --smoke`` in a child process (a fresh CUDA
                  context and its own TF32 setting): its last line has
                  `bench.py`'s top-level keys and the twin's `detail` keys,
                  every number finite, `value` 0 exactly when the last-20
                  return is below 195, `card` this card's `nvidia-smi`
                  name and power limit, TF32 off for matmul and cuDNN, and
                  the smoke's cuts listed under `reduced`; a child that
                  exits non-zero fails the phase. On the card the smoke
                  keeps every width (the pixel bench at B=128, 84x84x4,
                  rings of 512 and 2,048) and cuts depth only.
 45. per_learn    `tests/test_prioritized_replay.py`'s PER config (B=32, ring
                  256, (64, 64), sample 64) for 1,600 iterations to a
                  last-20 return above 100 (the JAX test's bar, which the
                  JAX package's own runs do not tighten), priorities
                  spread, then greedy eval over exactly 30 episodes; a
                  fifth child process.
 45a. lstm_kernel the LSTM recurrence's CUDA kernel (`ops/lstm_recurrence.py`)
                  at R2D2's shapes (H=512): the trained unroll of 80 steps
                  at 64 rows forward and backward, a burn-in of 40 without
                  gradient, the collect step at 256 rows; each against the
                  plain loop on the card (TF32 off, every output and
                  gradient to max|kernel - plain| <= 1e-5 + 1e-4
                  max|plain|), one launch a step and one for the backward's
                  start; timed, as the source of the port's kernel table:
                  ms of each case on CUDA events beside its bound (the
                  least time at the fp32 peak and HBM bandwidth), the plain
                  loop's and `torch.nn.LSTM`'s (cuDNN, no resets, width 531
                  in, the input product included on both sides). Runs
                  before the learning runs, on a quiet card; some 20 s, the
                  kernel's build included.
 46. kernels      the port's hand-written kernels on these paths (the LSTM
                  recurrence; the JAX package has no Pallas kernel at HEAD:
                  its recurrence is a `lax.scan`).
 47. total        the script's wall time; then {"kernels": [...]} (the row
                  of `lstm_kernel`), and as the last line {"ok": true,
                  "device": {...}}.
"""
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

from bench_torch import (HALFCHEETAH_ACT, HALFCHEETAH_OBS, SAC_MIN_TICKS,
                         SAC_POINT, card_line, free_card, halfcheetah_specs,
                         host_atari_replay_probe, random_halfcheetah,
                         sac_live_probe)

B_PARITY, B_MAIN = 64, 4096
MAIN = dict(capacity=512, sample_batch_size=256, fc=(100, 50))
# `main`'s sync-checked stretch: two periods of the target update (every 5).
WARMUP_ITERATIONS, MAIN_CHECKED, LEARN_ITERATIONS = 50, 10, 6000
# The `profiling.annotate` spans `main` wraps around its profiled window
# (a context manager) and the loop's `run` (a decorator); each opens once
# a window, so a window of one iteration shows both.
MAIN_SPANS = ("main.profile_window", "main.loop_run")
MAIN_PROFILED = 1
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
RUNS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                        "chip_smoke")
RTOL, ATOL = 1e-5, 1e-6
MNIH15 = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
CONV_PARITY = dict(pixels_size=20, env_batch_size=8, replay_capacity=64,
                   sample_batch_size=16, dtype="float32")
CONV_RTOL, CONV_ATOL = 1e-4, 1e-5
BF16_ATOL = 1e-2
# The pixel loops' sync-checked stretches cross no periodic branch: their
# target update comes every 500 train steps.
CONV_INITIAL, CONV_WARMUP, CONV_CHECKED = 64, 20, 10
CATCH_ITERATIONS, CATCH_CHUNK, CATCH_GATE = 2400, 400, 0.3
C51_WARMUP, C51_CHECKED = 10, 10
SAC_PARITY = dict(env_batch_size=8, replay_capacity=64, sample_batch_size=32,
                  train_steps_per_iteration=2)
SAC_RTOL = SAC_ATOL = 1e-5
# One iteration of the SAC, TD3 and QtOpt points is 32 train steps: past
# every period of theirs (target updates every step; TD3's actor every 2nd;
# QtOpt's delayed critics every 5th).
SAC_WARMUP, SAC_CHECKED = 2, 1
SAC_LEARN_CHUNK = 250
PPO_PARITY_ITERATIONS = 2
PPO_PARITY_SCHULMAN17 = dict(rollout_length=257, num_minibatches=4)
PPO_RTOL, PPO_ATOL, PPO_MOMENT_RTOL = 1e-4, 1e-5, 1e-3
# `ppo_main` hands its state to `ppo_learn` after 15 iterations, the last
# one collected and trained apart for its rollout's checks.
PPO_WARMUP, PPO_CHECKED = 2, 12
PPO_LEARN_CHUNK = 10
SCHULMAN17_CHECKED = 1
REINFORCE_CHECKED = 1
TD3_PARITY = dict(env_batch_size=8, replay_capacity=64, sample_batch_size=32,
                  train_steps_per_iteration=2, actor_fc_layers=(64, 64),
                  critic_joint_fc_layers=(64, 64))
TD3_PARITY_INITIAL, TD3_PARITY_ITERATIONS = 16, 5
TD3_WARMUP, TD3_CHECKED = 2, 1
DDPG_CHECKED = 1
TD3_LEARN_CHUNK, TD3_LEARN_GATE = 250, -250.0
CQL_RTOL, CQL_ATOL = 1e-4, 1e-5
CQL_PARITY_STEPS, CQL_PARITY_SAMPLE = 3, 256
CQL_RING_ROWS, CQL_RING_FRAMES = 32, 4096
# Train steps in each of the two phases of the kumar20 step (BC, then
# CQL); its target update comes every step.
CQL_CHECKED = 10
CQL_BC_GATE, CQL_OFFLINE_GATE, CQL_BEHAVIOR_GATE = -500.0, -700.0, -1000.0
BC_SCORE_GATE = 0.8
QTOPT_PARITY_B, QTOPT_PARITY_STEPS, QTOPT_PARITY_SAMPLE = 256, 3, 256
QTOPT_RTOL, QTOPT_ATOL, QTOPT_GAP = 1e-4, 1e-5, 1e-5
QTOPT_WARMUP, QTOPT_CHECKED = 2, 1
QTOPT_LEARN_CHUNK, QTOPT_LEARN_GATE = 250, -250.0
DISCRETE_B, DISCRETE_ENV_STEPS, DISCRETE_DQN_ITERATIONS = 64, 200, 3
CHILD_TIMEOUT_S = 900


class Clock:
  """The script's wall clock: each line's `phase_seconds` runs from the
  line before it (from the start for the first), so a phase's line gives
  the time the phase took; the last lines give the total."""

  def __init__(self):
    self.start = self.last = time.perf_counter()

  def lap(self):
    now = time.perf_counter()
    lap, self.last = now - self.last, now
    return lap

  def total(self):
    return time.perf_counter() - self.start


CLOCK = Clock()


def live_window(name):
  """A live-run bar (`LiveWindow`: a return to reach within a step
  budget) from the port's copy of the JAX package's windows,
  ``agents_tpu_torch/benchmark/return_windows.py``."""
  from agents_tpu_torch.benchmark import return_windows
  return getattr(return_windows, name)


def emit(phase, **fields):
  print(json.dumps({"phase": phase, **fields, "phase_seconds": CLOCK.lap()}),
        flush=True)


def fail(phase, message):
  emit(phase, ok=False, error=message)
  sys.exit(1)


def build_loop(device, batch_size, capacity, sample_batch_size, fc):
  """The example's loop (eps 0.1, gamma 0.99, tau 0.05 every 5, Adam 1e-3,
  seed 0) at this width."""
  from examples.dqn_cartpole_torch import Config
  from examples.dqn_cartpole_torch import build_loop as example_loop

  return example_loop(Config(
      env_batch_size=batch_size, replay_capacity=capacity,
      sample_batch_size=sample_batch_size, fc_layer_params=fc,
      device=device))


def numpy_q_params(rng, fc, obs_dim=4, num_actions=2, convs=(), image=None):
  """A flax-shaped Q-network param tree drawn with numpy; with `convs`, the
  encoder's leaf is an `image` (H, W, C) and Conv_i kernels are HWIO."""
  import numpy as np

  def layer(shape, scale):
    return {"kernel": rng.uniform(-scale, scale, shape).astype(np.float32),
            "bias": rng.uniform(-0.1, 0.1, shape[-1:]).astype(np.float32)}

  encoder, width = {}, obs_dim
  if convs:
    h, w, c = image
    for i, (filters, kernel, stride) in enumerate(convs):
      fan_in = kernel * kernel * c
      encoder[f"Conv_{i}"] = layer((kernel, kernel, c, filters),
                                   math.sqrt(6.0 / fan_in))
      h, w, c = -(-h // stride), -(-w // stride), filters
    width = h * w * c
  for i, out in enumerate(fc):
    encoder[f"Dense_{i}"] = layer((width, out), math.sqrt(6.0 / width))
    width = out
  return {"params": {"EncoderModule_0": encoder,
                     "Dense_0": layer((width, num_actions), 0.03)}}


def max_diff(a, b):
  return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def run_on_both(build, load, initial_collect_steps, iterations):
  """`build(device)`'s loop on "cpu" then "cuda", its networks set by
  `load(loop)`, the card replaying the CPU's stream of draws (an agent
  state that draws, as SAC's does, takes the same stream). Returns
  {device: (loop, state, losses)}."""
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws

  runs, records = {}, None
  for device in ("cpu", "cuda"):
    loop = build(device)
    load(loop)
    if device == "cpu":
      draws = RecordingDraws(Draws(0, "cpu"))
    else:
      draws = ReplayDraws(records, device)
    state = loop.init(draws=draws, initial_collect_steps=initial_collect_steps)
    if hasattr(state.agent_state, "draws"):
      state = dataclasses.replace(state, agent_state=dataclasses.replace(
          state.agent_state, draws=draws))
    state, losses = loop.run(state, iterations)
    if device == "cpu":
      records = draws.records
    runs[device] = (loop, state, losses)
  return runs


def dqn_tensors(agent_state):
  """The online and target Q networks' tensors by name."""
  return {f"{tag}.{k}": v
          for tag, net in (("q", "q_network"), ("target_q", "target_q_network"))
          for k, v in getattr(agent_state, net).state_dict().items()}


def state_tensors(agent_state):
  """Every network's tensors, every tensor field, every optimizer's
  moments and step counts, and the train step of an agent state, by
  name."""
  import torch

  out = {}
  for field in dataclasses.fields(agent_state):
    value = getattr(agent_state, field.name)
    if isinstance(value, torch.nn.Module):
      out.update({f"{field.name}.{k}": v
                  for k, v in value.state_dict().items()})
    elif isinstance(value, torch.Tensor):
      out[field.name] = value.detach()
    elif isinstance(value, torch.optim.Optimizer):
      params = [p for g in value.param_groups for p in g["params"]]
      for i, p in enumerate(params):
        for k, v in value.state.get(p, {}).items():
          out[f"{field.name}.{i}.{k}"] = v
  out["train_step"] = torch.tensor(agent_state.train_step)
  return out


def compare_runs(runs, rtol, atol, agent_tensors=dqn_tensors):
  """Largest float difference by name, and the names that disagree (floats
  beyond rtol/atol, anything else at all)."""
  import torch

  from agents_tpu_torch.utils import nest_utils

  (cloop, cstate, closses), (gloop, gstate, glosses) = runs["cpu"], runs["cuda"]
  diffs, mismatched = {}, []

  def compare(name, a, b):
    a, b = a.cpu(), b.cpu()
    if a.dtype.is_floating_point:
      diffs[name] = max_diff(a, b)
      if not torch.allclose(a, b, rtol=rtol, atol=atol):
        mismatched.append(name)
    elif not torch.equal(a, b):
      mismatched.append(name)

  compare("losses", closses, glosses)
  ctensors = agent_tensors(cstate.agent_state)
  gtensors = agent_tensors(gstate.agent_state)
  if set(ctensors) != set(gtensors):
    mismatched.append("agent_state.names")
  for k in ctensors:
    compare(k, ctensors[k], gtensors[k])
  cleaves = nest_utils.flatten(cstate.replay_state.storage)
  gleaves = nest_utils.flatten(gstate.replay_state.storage)
  names = ["step_type", "observation", "action", "next_step_type", "reward",
           "discount"]
  for name, a, b in zip(names, cleaves, gleaves):
    compare(f"replay.{name}", a, b)
  cres, gres = cloop.results(cstate), gloop.results(gstate)
  for k in cres:
    compare(f"metric.{k}", cres[k], gres[k])
  if cstate.replay_state.count != gstate.replay_state.count:
    mismatched.append("replay.count")
  return diffs, mismatched


def phase_parity():
  import numpy as np
  import torch

  from agents_tpu_torch.utils import convert

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  fc = (100, 50)
  state_dict = convert.q_params_to_state_dict(
      numpy_q_params(np.random.RandomState(0), fc))
  runs = run_on_both(
      lambda device: build_loop(device, B_PARITY, capacity=64,
                                sample_batch_size=64, fc=fc),
      lambda loop: loop.agent.q_network.load_state_dict(state_dict),
      initial_collect_steps=16, iterations=5)
  diffs, exact_mismatch = compare_runs(runs, RTOL, ATOL)
  worst = max(diffs, key=diffs.get)
  emit("parity", batch_size=B_PARITY, iterations=5, rtol=RTOL, atol=ATOL,
       largest_float_diff={"name": worst, "abs": diffs[worst]},
       loss_diff=diffs["losses"], replay_obs_diff=diffs["replay.observation"],
       mismatched=exact_mismatch, ok=not exact_mismatch)
  if exact_mismatch:
    fail("parity", f"card and CPU disagree on {exact_mismatch}")


def loop_tensors(state):
  """Every tensor a loop state holds: the driver, replay (if any) and
  metric states, and each network, tensor, tensor nest and optimizer of
  the agent state (optimizer step counters excepted: torch's
  non-capturable Adam keeps them on the host by design)."""
  import dataclasses

  import torch

  from agents_tpu_torch.utils import nest_utils

  replay = getattr(state, "replay_state", None)
  out = [x for x in nest_utils.flatten(
      (state.driver_state, replay.storage if replay else (),
       state.metric_states)) if isinstance(x, torch.Tensor)]
  for field in dataclasses.fields(state.agent_state):
    value = getattr(state.agent_state, field.name)
    if isinstance(value, torch.nn.Module):
      out += list(value.parameters()) + list(value.buffers())
    elif isinstance(value, torch.optim.Optimizer):
      for per_param in value.state.values():
        out += [v for k, v in per_param.items()
                if isinstance(v, torch.Tensor) and k != "step"]
    elif isinstance(value, torch.Tensor) or dataclasses.is_dataclass(value):
      out += [x for x in nest_utils.flatten(value)
              if isinstance(x, torch.Tensor)]
  return out


def check_step_types(loop, state):
  """Legal transitions over the whole ring: post-LAST is FIRST, and each
  frame's next step type is the following frame's step type."""
  import torch

  from agents_tpu_torch.replay_buffers.uniform_replay import ReplayState
  from agents_tpu_torch.trajectories.time_step import StepType

  # Only the two step-type leaves: a gather of every leaf would copy the
  # whole ring (7.4 GB of frames at the pixel bench point).
  storage, count = state.replay_state.storage, state.replay_state.count
  st, nst = loop.replay.gather_all(ReplayState(
      (storage.step_type, storage.next_step_type), count))
  size = loop.replay.size(state.replay_state)
  st, nst = st[:, :size], nst[:, :size]                     # [B, size]
  bad = int(((st == StepType.LAST) != (nst == StepType.FIRST)).sum())
  bad += int((nst[:, :-1] != st[:, 1:]).sum())
  newest = (state.replay_state.count - 1) % loop.replay.capacity
  bad += int((state.replay_state.storage.next_step_type[newest]
              != state.driver_state.time_step.step_type).sum())
  return bad, int((st == StepType.LAST).sum())


def profile_window(loop, state, iterations, spans=(), device_names=None):
  """`iterations` loop iterations under the port's `profiling.trace`
  (`torch.profiler`, CPU and CUDA), its chrome trace written under
  ``runs/chip_smoke/profile/``. With `spans` (outer, inner) the window is
  wrapped in a `profiling.annotate` span and the loop's `run` in a
  decorated one, and "spans_in_trace" says whether both reached the trace;
  with `device_names` ({key: part of a name}) "device_calls" counts the
  device ops (kernels, copies and sets) whose name holds each part.
  Returns (state, those fields)."""
  import torch

  from agents_tpu_torch.utils import profiling

  run = loop.run
  if spans:
    outer, inner = spans
    run = profiling.annotate(inner)(loop.run)

    def window():
      with profiling.annotate(outer):
        return run(state, iterations)
  else:
    def window():
      return run(state, iterations)
  torch.cuda.synchronize()
  log_dir = os.path.join(RUNS_DIR, "profile")
  with profiling.trace(log_dir):
    state, _ = window()
    torch.cuda.synchronize()
  with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
    events = json.load(f)["traceEvents"]
  stats = {"iterations": iterations}
  if spans:
    names = {e.get("name") for e in events}
    stats["spans_in_trace"] = {s: s in names for s in spans}
  if device_names:
    ops = [e["name"] for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_ACTIVITIES]
    stats["device_calls"] = {k: sum(1 for op in ops if part in op)
                             for k, part in device_names.items()}
  return state, stats


def sync_checked(run, state, count):
  """`run(state, count)` (a loop's `run`, or a function that takes `count`
  train steps) under ``torch.cuda.set_sync_debug_mode("error")``, which
  raises on any host sync inside it; the mode is off again after. Returns
  what `run` returns: (state, losses)."""
  import torch

  torch.cuda.set_sync_debug_mode("error")
  try:
    return run(state, count)
  finally:
    torch.cuda.set_sync_debug_mode(0)


def phase_main_and_learn(card):
  import torch

  loop = build_loop("cuda", B_MAIN, **MAIN)
  state = loop.init(seed=0, initial_collect_steps=100)
  state, losses = loop.run(state, WARMUP_ITERATIONS)
  state, losses = sync_checked(loop.run, state, MAIN_CHECKED)

  iterations = WARMUP_ITERATIONS + MAIN_CHECKED
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  finite = bool(torch.isfinite(losses).all())
  expected_count = 100 + iterations
  bad_transitions, lasts = check_step_types(loop, state)
  replay_count = state.replay_state.count
  ok = (not off_card and finite and bad_transitions == 0
        and replay_count == expected_count)
  state, prof = profile_window(loop, state, MAIN_PROFILED, spans=MAIN_SPANS)
  ok = ok and all(prof["spans_in_trace"].values())
  iterations += MAIN_PROFILED
  emit("main", card=card, batch_size=B_MAIN, **{k: list(v) if isinstance(
      v, tuple) else v for k, v in MAIN.items()},
       checked_iterations=MAIN_CHECKED, sync_debug_mode="error",
       tensors_off_card=off_card,
       losses_finite=finite, replay_count=replay_count,
       expected_replay_count=expected_count,
       illegal_step_type_transitions=bad_transitions,
       last_frames_in_ring=lasts, profile=prof, ok=ok)
  if not ok:
    fail("main", "main-path checks failed")

  while iterations < LEARN_ITERATIONS:
    n = min(500, LEARN_ITERATIONS - iterations)
    state, losses = loop.run(state, n)
    iterations += n
  results = {k: float(v) for k, v in loop.results(state).items()}
  gate = live_window("DQN_CARTPOLE_REFERENCE_LIVE").min_return
  ok = results["AverageReturn"] >= gate and bool(torch.isfinite(losses).all())
  emit("learn", card=card, iterations=iterations,
       last20_average_return=results["AverageReturn"], metrics=results, ok=ok)
  if not ok:
    fail("learn", f"last-20 AverageReturn {results['AverageReturn']} < "
         f"{gate}")
  return loop, state


def phase_eval(loop, state, card):
  out = loop.evaluate(state, 101, num_episodes=30, max_steps=2000)
  episodes = int(out["NumberOfEpisodes"])
  ok = episodes == 30
  emit("eval", card=card, episodes=episodes,
       average_return=float(out["AverageReturn"]),
       average_episode_length=float(out["AverageEpisodeLength"]), ok=ok)
  if not ok:
    fail("eval", f"counted {episodes} episodes, asked for 30")


EXPORT_INTERVAL, EXPORT_ITERATIONS, EXPORT_TIE = 500, 1000, 1e-5
EVAL_JOB_TIMEOUT_S = 180

# The child of `learner_export`: numpy and torch only, the artifact's own
# loader, on "cuda" and on "cpu"; on "cuda" it also acts on one row, as the
# batch-polymorphic program must.
ARTIFACT_CHILD = """
import importlib.util, json, sys
import numpy as np
import torch
directory, obs_path, out_path = sys.argv[1:4]
spec = importlib.util.spec_from_file_location(
    "artifact_loader", directory + "/loader.py")
loader = importlib.util.module_from_spec(spec)
spec.loader.exec_module(loader)
obs = np.load(obs_path)
opened = []


class Span:
  def __init__(self, name, request=False):
    self.name = name

  def __enter__(self):
    opened.append(self.name)

  def __exit__(self, *exc):
    return None


out = {}
for platform in ("cuda", "cpu"):
  policy = loader.ExportedPolicy(directory, platform=platform)
  (out[platform],), _ = policy.action([obs])
  if platform == "cuda":
    policy.span_hook = Span
    replayed = [policy.action([obs])[0][0] for _ in range(2)]
    policy.span_hook = None
    policy.action([obs[:1]])
np.savez(out_path, **out)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
    "agents_tpu", "agents_tpu_torch", "jax", "jaxlib", "flax"))
print(json.dumps({"leaked": leaked, "torch": torch.__version__,
                  "replays": opened.count("act.replay"),
                  "replays_equal": all(np.array_equal(a, out["cuda"])
                                       for a in replayed)}))
"""


def artifact_actions(phase, directory, obs, root):
  """The artifact in `directory` acting on the numpy `obs` in a child that
  imports numpy and torch only (`ARTIFACT_CHILD`), on "cuda" and "cpu":
  ({platform: actions}, the child's report). On "cuda" the child calls
  the policy three times on `obs`: the first call runs the program op by
  op, the next two replay its CUDA graph, and `phase` fails unless both
  replays ran and acted as the first call did."""
  import numpy as np

  obs_path = os.path.join(root, "observations.npy")
  out_path = os.path.join(root, "artifact_actions.npz")
  np.save(obs_path, obs)
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  child = subprocess.run(
      [sys.executable, "-c", ARTIFACT_CHILD, directory, obs_path, out_path],
      capture_output=True, text=True, timeout=300, env=env, cwd=root)
  if child.returncode != 0:
    fail(phase, "the artifact's child failed: " + child.stderr[-2000:])
  with np.load(out_path) as data:
    actions = {p: data[p] for p in data.files}
  report = json.loads(child.stdout.strip().splitlines()[-1])
  if report["replays"] != 2 or not report["replays_equal"]:
    fail(phase, f"the artifact's CUDA graph: {report['replays']} replays "
         f"of 2, actions as the first call's: {report['replays_equal']}")
  return actions, report


def _crc32c(data: bytes) -> int:
  """CRC-32C (Castagnoli, reflected 0x82F63B78), bit by bit: the script's
  own, independent of the writer's."""
  crc = 0xFFFFFFFF
  for byte in data:
    crc ^= byte
    for _ in range(8):
      crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
  return crc ^ 0xFFFFFFFF


def _varint(buf, pos):
  value, shift = 0, 0
  while True:
    b = buf[pos]
    pos += 1
    value |= (b & 0x7F) << shift
    shift += 7
    if not b & 0x80:
      return value, pos


def _proto_fields(buf):
  """(field number, wire type, value) of a protobuf message: varints as
  ints, 64- and 32-bit fields as raw bytes, length-delimited as bytes."""
  pos, out = 0, []
  while pos < len(buf):
    key, pos = _varint(buf, pos)
    field, wire = key >> 3, key & 7
    if wire == 0:
      value, pos = _varint(buf, pos)
    elif wire == 1:
      value, pos = buf[pos:pos + 8], pos + 8
    elif wire == 5:
      value, pos = buf[pos:pos + 4], pos + 4
    elif wire == 2:
      n, pos = _varint(buf, pos)
      value, pos = buf[pos:pos + n], pos + n
    else:
      raise ValueError(f"wire type {wire}")
    out.append((field, wire, value))
  return out


def read_event_file(path):
  """A TensorBoard events file read back by the script alone: its TFRecord
  framing (u64 length, masked CRC-32C of the length, payload, masked
  CRC-32C of the payload) and each `Event` (1 wall_time, 2 step, 3
  file_version, 5 summary of `Value`s {1 tag, 2 simple_value}). Returns
  (records, CRC mismatches, file_version, [(step, tag, value)])."""
  import struct

  def masked(data):
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF

  data = open(path, "rb").read()
  pos, records, bad, version, scalars = 0, 0, 0, None, []
  while pos < len(data):
    header = data[pos:pos + 8]
    (length,), (hcrc,) = (struct.unpack("<Q", header),
                          struct.unpack("<I", data[pos + 8:pos + 12]))
    payload = data[pos + 12:pos + 12 + length]
    (pcrc,) = struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])
    bad += (masked(header) != hcrc) + (masked(payload) != pcrc)
    pos += 16 + length
    records += 1
    step = 0
    for field, _, value in _proto_fields(payload):
      if field == 2:
        step = value
      elif field == 3:
        version = value.decode()
      elif field == 5:
        for _, _, v in _proto_fields(value):
          tag, simple = None, None
          for f, _, x in _proto_fields(v):
            if f == 1:
              tag = x.decode()
            elif f == 2:
              (simple,) = struct.unpack("<f", x)
          if simple is not None:
            scalars.append((step, tag, simple))
  return records, bad, version, scalars


def phase_learner_export(loop, state, card):
  """The trained bench-point state into the port's `Learner` under a
  temporary root_dir: checkpoints and a `PolicyCheckpointTrigger` every
  500 of 1,000 iterations; a fresh Learner resumes at 1,000 bit for bit;
  the greedy artifact acts in a numpy-and-torch-only child on "cuda" and
  "cpu" as the live policy does; `load_policy(dir)` alone evaluates 30
  episodes to the `eval` bar. Returns the root_dir, the greedy
  directory's train step and the loop state, for `eval_job`."""
  import numpy as np
  import torch

  from agents_tpu_torch.eval import metric_utils
  from agents_tpu_torch.metrics import torch_metrics
  from agents_tpu_torch.policies.policy_saver import load_manifest, load_policy
  from agents_tpu_torch.train import (JsonlSummaryWriter, Learner,
                                      MultiWriter, PolicyCheckpointTrigger,
                                      TensorBoardEventWriter)
  from agents_tpu_torch.train.checkpointer import capture
  from agents_tpu_torch.trajectories import time_step as ts
  from agents_tpu_torch.utils.draws import Draws

  os.makedirs(RUNS_DIR, exist_ok=True)
  root = tempfile.mkdtemp(prefix="learner_export_", dir=RUNS_DIR)
  agent = loop.agent
  holder = {}
  trigger = PolicyCheckpointTrigger(
      root, agent, lambda: holder["learner"].state.agent_state,
      EXPORT_INTERVAL)
  tb_dir = os.path.join(root, "tb")
  writer = MultiWriter(JsonlSummaryWriter(os.path.join(root, "train.jsonl")),
                       TensorBoardEventWriter(tb_dir))
  learner = holder["learner"] = Learner(
      root, loop=loop, initial_state=state, triggers=[trigger],
      checkpoint_interval=EXPORT_INTERVAL, summary_writer=writer,
      summary_interval=EXPORT_INTERVAL)
  while learner.global_step < EXPORT_ITERATIONS:
    loss = learner.run(EXPORT_INTERVAL)
  writer.close()
  # The events file read back by the script's own reader, beside the JSONL
  # lines the same writer wrote: every scalar in both, the same values.
  (events_file,) = os.listdir(tb_dir)
  records, crc_bad, file_version, tb_scalars = read_event_file(
      os.path.join(tb_dir, events_file))
  with open(os.path.join(root, "train.jsonl")) as f:
    jsonl = [(r["step"], k, v) for r in map(json.loads, f)
             for k, v in r.items() if k not in ("step", "t")]
  tb_ok = (crc_bad == 0 and file_version == "brain.Event:2"
           and records == len(tb_scalars) + 1
           and len(tb_scalars) == len(jsonl) > 0
           and all(s == js and t == jt and abs(v - jv) <= 1e-6 * max(
               1.0, abs(jv)) for (s, t, v), (js, jt, jv) in zip(tb_scalars,
                                                                jsonl)))
  ckpt_dir = learner.checkpointer.directory
  steps = learner.checkpointer.all_steps()
  ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, f"{steps[-1]}.pt"))

  # A fresh loop and Learner on the same directory resume at 1,000.
  loop2 = build_loop("cuda", B_MAIN, **MAIN)
  learner2 = Learner(root, loop=loop2, initial_state=loop2.init(seed=1),
                     checkpoint_interval=EXPORT_INTERVAL)
  mismatches = nest_mismatches(capture(learner.state),
                               capture(learner2.state))
  resumed_step = learner2.global_step
  del learner2, loop2

  # The greedy artifact in a numpy-and-torch-only child.
  greedy_dir = os.path.join(root, "policies", "greedy_policy")
  manifest = load_manifest(greedy_dir)
  q_net = agent.policy_params(learner.state.agent_state)
  obs = learner.state.driver_state.time_step.observation
  artifact, report = artifact_actions(
      "learner_export", greedy_dir, obs.cpu().numpy(), root)
  b = obs.shape[0]
  step = ts.TimeStep(step_type=torch.ones(b, dtype=torch.int32, device="cuda"),
                     reward=torch.zeros(b, device="cuda"),
                     discount=torch.ones(b, device="cuda"), observation=obs)
  with torch.no_grad():
    live = agent.policy.action(q_net, step).action.cpu().numpy()
    q = q_net(obs)[0].cpu().numpy()
  top2 = np.sort(q, axis=-1)[:, -2:]
  clear = (top2[:, 1] - top2[:, 0]) > EXPORT_TIE
  differ = {p: int((artifact[p][clear] != live[clear]).sum())
            for p in ("cuda", "cpu")}

  # load_policy(dir) alone, on the device CartPole.
  saved = load_policy(greedy_dir)
  metrics = (torch_metrics.AverageReturnMetric(30),
             torch_metrics.AverageEpisodeLengthMetric(30),
             torch_metrics.NumberOfEpisodes())
  out = metric_utils.evaluate_torch_env_episodes(
      loop.env, saved.policy, saved.params, Draws(101, "cuda"), 30, 2000,
      metrics)
  episodes = int(out["NumberOfEpisodes"])
  eval_return = float(out["AverageReturn"])
  gate = live_window("DQN_CARTPOLE_REFERENCE_LIVE").min_return
  artifact_bytes = {
      name: sum(os.path.getsize(os.path.join(root, "policies", name, f))
                for f in os.listdir(os.path.join(root, "policies", name)))
      for name in sorted(os.listdir(os.path.join(root, "policies")))}
  ok = (math.isfinite(loss) and steps == [EXPORT_INTERVAL, EXPORT_ITERATIONS]
        and tb_ok and resumed_step == EXPORT_ITERATIONS and not mismatches
        and manifest["torch_export"] == "batch-polymorphic"
        and manifest["policy_config"] is not None
        and not report["leaked"] and not any(differ.values())
        and episodes == 30 and eval_return >= gate)
  emit("learner_export", card=card, batch_size=B_MAIN,
       iterations=EXPORT_ITERATIONS, checkpoint_interval=EXPORT_INTERVAL,
       export_interval=EXPORT_INTERVAL, checkpoints=steps,
       checkpoint_bytes=ckpt_bytes,
       tensorboard={"records": records, "crc_mismatches": crc_bad,
                    "file_version": file_version,
                    "scalars": len(tb_scalars), "jsonl_scalars": len(jsonl),
                    "tags": sorted({t for _, t, _ in tb_scalars}),
                    "ok": tb_ok},
       resumed_at=resumed_step, resume_mismatches=mismatches[:10],
       export=manifest["torch_export"],
       export_train_step=manifest["train_step"],
       artifact_bytes=artifact_bytes, child_modules_leaked=report["leaked"],
       child_torch=report["torch"], rows=b,
       rows_clear_of_ties=int(clear.sum()), tie=EXPORT_TIE,
       actions_differing_from_live=differ, reloaded_eval_episodes=episodes,
       reloaded_eval_return=eval_return, gate=gate, ok=ok)
  if not ok:
    fail("learner_export", "a learner, export or reload check failed")
  return root, manifest["train_step"], learner.state


def eval_job_child(root):
  """`examples/eval_job_torch.py`'s loop on "cuda" over random envs with
  CartPole's specs (the card's machine has no gymnasium), 2 evals."""
  from agents_tpu_torch.environments.classic import CartPole
  from agents_tpu_torch.environments.test_envs import RandomPyEnvironment
  from examples import eval_job_torch

  cartpole = CartPole()
  seeds = iter(range(100))
  eval_job_torch.main(
      [f"--root_dir={root}", "--max_evals=2", "--eval_episodes=5",
       "--poll_secs=0.1"],
      make_env=lambda: RandomPyEnvironment(
          cartpole.observation_spec(), cartpole.action_spec(),
          max_duration=50, seed=next(seeds)))


def phase_eval_job(loop, state, card, root, train_step):
  """The eval job in a child process against `learner_export`'s export:
  it evaluates the greedy policy at `train_step`, the parent refreshes
  the export's params at a higher train step, and the child evaluates
  again and exits."""
  import threading

  from agents_tpu_torch.policies.policy_saver import PolicySaver

  greedy_dir = os.path.join(root, "policies", "greedy_policy")
  proc = subprocess.Popen(
      [sys.executable, os.path.abspath(__file__), "--eval-job", root],
      stdout=subprocess.PIPE, text=True)
  watchdog = threading.Timer(EVAL_JOB_TIMEOUT_S, proc.kill)
  watchdog.start()
  evals, refreshed = [], train_step + 1
  try:
    for line in proc.stdout:
      if not line.startswith("{"):
        continue
      rec = json.loads(line)
      if "train_step" not in rec:
        continue
      evals.append(rec)
      if len(evals) == 1:
        PolicySaver(loop.agent.policy, train_step=refreshed).save_checkpoint(
            greedy_dir, loop.agent.policy_params(state.agent_state))
    code = proc.wait(timeout=60)
  finally:
    watchdog.cancel()
    if proc.poll() is None:
      proc.kill()
      proc.wait()
  ok = (code == 0 and [e["train_step"] for e in evals]
        == [train_step, refreshed])
  emit("eval_job", card=card, evals=evals, exit_code=code, ok=ok)
  shutil.rmtree(root, ignore_errors=True)
  if not ok:
    fail("eval_job", f"the child reported {evals}, exit {code}")


# data_parallel: the bench point over a mesh (`bench.py:398-420`), and the
# PPO CartPole point (`examples/ppo_cartpole.py`: B=32, T=128, 10 x 8
# minibatches, (64, 64)) with 2 minibatch shards.
DP_FUSED = dict(batch_size=B_MAIN, capacity=512, sample_batch_size=256,
                fc=(100, 50))
DP_PPO = dict(batch_size=32, rollout_length=128, num_epochs=10,
              num_minibatches=8, num_minibatch_shards=2, fc=(64, 64))
# (a)'s collectives are counted over two periods of the target update.
DP_INITIAL, DP_WARMUP, DP_COUNTED, DP_ITERATIONS = 100, 20, 10, 3
DP_RANKS, DP_SEED, DP_TIMEOUT_S = 2, 11, 600
DP_PPO_HELD = 2   # PPO's whole-run iterations held to the plain process
DP_PPO_CLIPPING = 0.2   # PPOClipAgent's importance_ratio_clipping


def dp_rank(mesh, jobs, bandit_batches):
  """A gloo rank on the card: first which collectives gloo takes on CUDA
  tensors as they are (each tried once, synchronised), then
  `dryrun.run_jobs`, whose mesh hands gloo its CUDA tensors directly, and
  LinUCB's statistics over the ranks (`dryrun.run_bandit`)."""
  import torch
  import torch.distributed as dist

  import torch_dryrun as dryrun

  probe = {}
  for kind, call in (
      ("all_reduce", lambda t: dist.all_reduce(t)),
      ("broadcast", lambda t: dist.broadcast(t, 0)),
      ("all_gather", lambda t: dist.all_gather(
          [torch.empty_like(t) for _ in range(mesh.size)], t))):
    t = torch.full((4,), float(mesh.rank + 1), device="cuda")
    try:
      call(t)
      torch.cuda.synchronize()
      probe[kind] = "ok"
    except (RuntimeError, ValueError) as e:
      probe[kind] = f"{type(e).__name__}: {str(e)[:200]}"
  return {"gloo_cuda_direct": probe, "jobs": dryrun.run_jobs(mesh, jobs),
          "bandit": dryrun.run_bandit(mesh, bandit_batches,
                                      DP_BANDIT["context_dim"],
                                      DP_BANDIT["num_actions"])}


def dp_compare(merged, reference):
  """Tensors of the ranks' merged state that leave the reference: floats
  per tensor past max|d| <= 1e-5 + 1e-4 max|ref| (the card-phase rule),
  anything else unequal. Returns (mismatches, the largest float |d|)."""
  import torch

  bad, worst = [], 0.0
  for key, want in reference.items():
    got = merged.get(key)
    if got is None or got.shape != want.shape:
      bad.append(key)
    elif want.is_floating_point():
      if want.numel() == 0:
        continue
      d = float((got - want).abs().max())
      worst = max(worst, d)
      if d > 1e-5 + 1e-4 * float(want.abs().max()):
        bad.append(key)
    elif not torch.equal(got, want):
      bad.append(key)
  return bad, worst


def phase_data_parallel(card):
  """(a) The bench point through `FusedTrainLoop(mesh=)` over a one-rank
  NCCL group; (b) two gloo ranks on the card, 2,048 rows each, for
  the fused DQN loop, PER and sharded PPO, each against one process over
  the global batch and the ranks' draws."""
  import functools

  import torch
  import torch.distributed as dist

  import torch_dryrun as dryrun
  from agents_tpu_torch.parallel import (create_mesh, distributed,
                                         shard_loop_state)

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  os.makedirs(RUNS_DIR, exist_ok=True)
  workdir = tempfile.mkdtemp(prefix="data_parallel_", dir=RUNS_DIR)

  # (a) One NCCL rank: every collective is a real NCCL call.
  distributed.initialize(num_processes=1, process_id=0, backend="nccl",
                         init_method="file://" + os.path.join(workdir,
                                                              "nccl"))
  try:
    mesh = create_mesh(1, device="cuda")
    loop = dryrun.build_fused_loop(mesh, device="cuda", **DP_FUSED)
    state = loop.init(seed=0, initial_collect_steps=DP_INITIAL)
    state = shard_loop_state(state, mesh, DP_FUSED["batch_size"],
                             DP_FUSED["capacity"], draws=state.draws)
    state, _ = loop.run(state, DP_WARMUP)
    try:
      state, _ = sync_checked(loop.run, state, 1)
      sync_free = True
    except RuntimeError:
      sync_free = False
    mesh.reset_bytes()
    state, losses = loop.run(state, DP_COUNTED)
    nccl = {"bytes_per_iteration": mesh.bytes_passed / DP_COUNTED,
            "collectives_per_iteration": mesh.calls / DP_COUNTED,
            "sync_free": sync_free,
            "losses_finite": bool(torch.isfinite(losses).all())}
    del loop, state
  finally:
    dist.destroy_process_group()
  free_card()

  # (b) Two gloo ranks on the card, then one process over the global batch
  # replaying the ranks' draws (PER sampled as two equal-mass shards).
  fused = functools.partial(dryrun.build_fused_loop, device="cuda",
                            **DP_FUSED)
  ppo = functools.partial(dryrun.build_ppo_loop, device="cuda",
                          record_surrogate=True, **DP_PPO)
  cases = {
      "dqn": (fused, fused, DP_FUSED["batch_size"], DP_INITIAL),
      "per": (functools.partial(fused, prioritized=True),
              functools.partial(fused, reference_shards=DP_RANKS),
              DP_FUSED["batch_size"], DP_INITIAL),
      "ppo": (ppo, ppo, DP_PPO["batch_size"], 0)}
  # PPO's state is small, so its ranks keep it before and after each
  # iteration: each iteration is also held on its own (`step_from`).
  jobs = [(build, DP_SEED, [DP_SEED] * DP_RANKS, DP_ITERATIONS, steps,
           name == "ppo")
          for name, (build, _, _, steps) in cases.items()]
  bandit_batches = dryrun.bandit_batches(
      DP_SEED, DP_BANDIT["batch_size"], DP_BANDIT["calls"],
      DP_BANDIT["context_dim"], DP_BANDIT["num_actions"])
  ranks = dryrun.spawn_ranks(dp_rank, DP_RANKS, (jobs, bandit_batches),
                             os.path.join(workdir, "gloo"), backend="gloo",
                             device="cuda", timeout_s=DP_TIMEOUT_S)
  out, ok = {}, nccl["losses_finite"]
  for j, (name, (_, reference, rows, steps)) in enumerate(cases.items()):
    runs = [r["jobs"][j] for r in ranks]
    merged, differ = dryrun.merge_snapshots([r["snapshot"] for r in runs])
    records = dryrun.merge_records([r["records"] for r in runs],
                                   rows // DP_RANKS)
    one = dryrun.run_rank(None, reference, runs[0]["init_records"],
                          dryrun.concat_records(records), DP_ITERATIONS,
                          steps, every_iteration=name == "ppo")
    mismatches, worst = dp_compare(merged, one["snapshot"])
    held = {"iterations": "the whole run from one start",
            "mismatches": mismatches[:10], "largest_float_diff": worst}
    if name == "ppo":
      # 80 Adam steps an iteration amplify any change of float order, and
      # on the card a GEMM over one rank's row block rounds its rows
      # otherwise than over all rows. So PPO's whole run is held against
      # a witness that is the one process with every linear layer in the
      # ranks' row blocks, and against the plain one process for its
      # first DP_PPO_HELD iterations; both clipped surrogates' traces
      # against the ranks' are printed (`python torch_dryrun.py` runs
      # more seeds and iterations), and each iteration is also held from
      # the ranks' own state before it (`step_from`).
      with dryrun.linear_in_row_blocks(DP_RANKS):
        witness = dryrun.run_rank(None, reference, runs[0]["init_records"],
                                  dryrun.concat_records(records),
                                  DP_ITERATIONS, steps, every_iteration=True)
      ends = [dryrun.merge_snapshots([r["snapshots"][i] for r in runs])[0]
              for i in range(1, DP_ITERATIONS + 1)]
      divergence = dryrun.divergence(ends, one["snapshots"][1:])
      from_witness = dryrun.divergence(ends, witness["snapshots"][1:])
      mismatches = [f"whole run, iteration {i}: {d['tensor']}"
                    for i, d in enumerate(divergence, 1)
                    if i <= DP_PPO_HELD and d["over_tolerance"] > 1] + [
          f"whole run from the witness, iteration {i}: {d['tensor']}"
          for i, d in enumerate(from_witness, 1) if d["over_tolerance"] > 1]
      per_iteration = DP_PPO["num_epochs"] * DP_PPO["num_minibatches"]
      traces = [r["surrogate"] for r in runs]
      held.update(
          mismatches=mismatches[:10], held_through_iteration=DP_PPO_HELD,
          divergence_by_iteration=divergence,
          from_witness_by_iteration=from_witness,
          witness_by_iteration=dryrun.divergence(witness["snapshots"][1:],
                                                 one["snapshots"][1:]),
          surrogate=dryrun.surrogate_trace(traces, one["surrogate"],
                                           DP_PPO_CLIPPING, per_iteration),
          surrogate_from_witness=dryrun.surrogate_trace(
              traces, witness["surrogate"], DP_PPO_CLIPPING, per_iteration))
      starts = [dryrun.merge_snapshots([r["snapshots"][i] for r in runs])[0]
                for i in range(DP_ITERATIONS + 1)]
      stepped = dryrun.step_from(reference, runs[0]["init_records"],
                                 starts[:-1], records, steps)
      step_bad, step_worst = [], 0.0
      for i, (_, snap) in enumerate(stepped):
        bad, w = dp_compare(starts[i + 1], snap)
        step_bad += [f"iteration {i + 1}: {k}" for k in bad]
        step_worst = max(step_worst, w)
      held = {"whole_run": held, "each_iteration": {
          "iterations": "each from the ranks' state before it",
          "mismatches": step_bad[:10], "largest_float_diff": step_worst}}
      mismatches += step_bad
    loss_d = max(abs(a - b) for r in runs
                 for a, b in zip(r["losses"], one["losses"]))
    snap = runs[0]["snapshot"]
    nets = ((("agent.actor_network.", "agent.value_network."), 128,
             DP_PPO["num_epochs"] * DP_PPO["num_minibatches"])
            if name == "ppo" else (("agent.q_network.",), 1, 1))
    param_bytes = sum(v.numel() * v.element_size() for k, v in snap.items()
                      if k.startswith(nets[0]))
    opt_bytes = sum(v.numel() * v.element_size() for k, v in snap.items()
                    if k.startswith("agent.optimizer."))
    # Per collect step: each deque metric's rows (done and value, float32)
    # and each counter's int64 sum.
    metric_rows = nets[1] * (rows // DP_RANKS * 8 * 2 + 2 * 8)
    bound = nets[2] * param_bytes + opt_bytes + metric_rows
    used = max(b for r in runs for b in r["bytes_per_iteration"])
    largest = {}
    for r in runs:
      for kind, numel in r["largest_numel"].items():
        largest[kind] = max(largest.get(kind, 0), numel)
    # Only the gradient's all-reduce (and scalars) and the metric rows'
    # all-gathers (done and value per row): nothing replay- or
    # rollout-sized crosses ranks.
    collectives_ok = (set(largest) == {"all_reduce", "all_gather"}
                      and largest["all_reduce"] == param_bytes // 4
                      and largest["all_gather"] <= rows // DP_RANKS * 2)
    case_ok = (not mismatches and not differ and used <= bound
               and collectives_ok
               and all(math.isfinite(x) for x in one["losses"]))
    ok = ok and case_ok
    out[name] = {"held": held, "loss_diff": loss_d,
                 "replicated_differing": differ[:10],
                 "bytes_per_iteration": used, "bytes_bound": bound,
                 "param_bytes": param_bytes, "optimizer_bytes": opt_bytes,
                 "largest_collective_numel": largest,
                 "gradient_numel": param_bytes // 4,
                 "metric_rows_numel": rows // DP_RANKS * 2,
                 "collectives_per_iteration": max(
                     c for r in runs for c in r["calls_per_iteration"]),
                 "losses": one["losses"], "ok": case_ok}
  # (c) LinUCB: the ranks' statistics against one process over all rows.
  one = dryrun.run_bandit(None, bandit_batches, DP_BANDIT["context_dim"],
                          DP_BANDIT["num_actions"], device="cuda")
  runs = [r["bandit"] for r in ranks]
  per_call = dryrun.bandit_statistics_bytes(DP_BANDIT["context_dim"],
                                            DP_BANDIT["num_actions"])
  bad, worst = [], 0.0
  for name in ("a_mat", "b_vec", "num_samples"):
    ref = one[name]
    for r in runs:
      d = max_diff(r[name], ref)
      worst = max(worst, d)
      if d > 1e-5 + 1e-4 * float(ref.abs().max()):
        bad.append(name)
      if not torch.equal(r[name], runs[0][name]):
        bad.append(f"{name} differs across ranks")
  bandit_ok = (not bad and all(
      r["bytes_per_call"] == [per_call] * DP_BANDIT["calls"]
      and r["calls_per_call"] == [1] * DP_BANDIT["calls"]
      and r["largest_numel"] == {"all_reduce": per_call // 4}
      and r["train_step"] == DP_BANDIT["calls"] for r in runs))
  ok = ok and bandit_ok
  out["linucb"] = {"mismatches": bad, "largest_float_diff": worst,
                   "bytes_per_train_call": [r["bytes_per_call"]
                                            for r in runs],
                   "statistics_bytes": per_call,
                   "collectives_per_train_call": [r["calls_per_call"]
                                                  for r in runs],
                   "largest_collective_numel": [r["largest_numel"]
                                                for r in runs],
                   "ok": bandit_ok, **DP_BANDIT}
  emit("data_parallel", card=card, nccl_one_rank=nccl,
       gloo_two_ranks=out,
       gloo_cuda_direct=[r["gloo_cuda_direct"] for r in ranks],
       tolerance="max|d| <= 1e-5 + 1e-4 max|ref| per tensor; replicated "
       "bit-equal across ranks", fused=DP_FUSED, ppo=DP_PPO,
       iterations=DP_ITERATIONS, ok=ok)
  if not ok:
    fail("data_parallel", "a data-parallel check failed")


# -- bandits -------------------------------------------------------------------

BANDIT_SCENARIOS = ("linucb_stationary", "lints_stationary",
                    "neural_eps_greedy", "neural_linucb", "ranking")
# Rounds the CPU runs alone first (the statistics and networks leave their
# initial ties), so that the compared rounds straddle the end of
# NeuralLinUCB's 100-round encoding phase.
BANDIT_PARITY_WARMUP, BANDIT_PARITY_ROUNDS = 98, 4
BANDIT_GAP = 1e-5        # of max|score|: decisions closer than this may part
# `bandit_main`'s sync-checked rounds run past NeuralLinUCB's 100-step
# encoding phase.
BANDIT_WARMUP, BANDIT_CHECKED = 10, 100
BANDIT_LEARN = ("linucb_stationary", "neural_eps_greedy")
# The JAX example's runs at its default config over seeds 0-4
# (`tests/test_torch_reference_bars.py bandit`, `bandit_bar`: the worst
# seed plus a third of the spread): the largest regret and suboptimal-arm
# share of the last 200-round window.
BANDIT_LEARN_BARS = {
    "linucb_stationary": {"regret": 0.0005521289228151242,
                          "suboptimal_arms": 0.003795572789385915},
    "neural_eps_greedy": {"regret": 0.24547086159388223,
                          "suboptimal_arms": 0.1161718765894572},
}
BANDIT_SCENARIO_ROUNDS, BANDIT_SCENARIO_LOG = 20, 10
# data_parallel (c): the example's LinUCB over two ranks.
DP_BANDIT = dict(batch_size=256, calls=3, context_dim=8, num_actions=5)


def bandit_config(device, **fields):
  from examples import bandits_train_eval_torch as example
  return example.Config(device=device, root_dir=os.path.join(
      RUNS_DIR, "bandits"), **fields)


def _score_gaps(scores):
  """Per row, the gap between its two best scores over max|scores|."""
  import torch

  top2 = torch.topk(scores, 2, dim=-1).values
  scale = float(scores.abs().max()) or 1.0
  return (top2[:, 0] - top2[:, 1]) / scale


def bandit_decision_gaps(scenario, agent, agent_state, time_step, records):
  """The relative gap of each row's first-step decision, on the CPU's
  state: the two best scores of the policy it acted with (the ranking
  slate: the smallest over its picks)."""
  import torch

  from agents_tpu_torch.bandits.policies import linalg
  from agents_tpu_torch.bandits.policies.linear_bandit_policy import \
      ucb_scores
  from agents_tpu_torch.bandits.specs.bandit_spec_utils import \
      PER_ARM_FEATURE_KEY
  from agents_tpu_torch.utils.draws import ReplayDraws

  obs = time_step.observation
  with torch.no_grad():
    if scenario in ("linucb_stationary", "lints_stationary"):
      draws = ReplayDraws({"lints_eps": records.get("lints_eps", [])[:1]},
                          "cpu")
      return _score_gaps(agent.policy._scores(agent_state, obs, draws))
    if scenario == "neural_eps_greedy":
      return _score_gaps(agent_state.params(obs)[0])
    if scenario == "neural_linucb":
      (feats, _), _ = agent_state.encoder_params(obs)
      chol = linalg.cholesky(agent_state.a_mat)
      theta = torch.cholesky_solve(agent_state.b_vec[..., None],
                                   chol)[..., 0]
      return _score_gaps(ucb_scores(chol, theta, feats, agent.alpha))
    # ranking: the gap at each pick of `_RankingPolicy`.
    policy = agent.policy
    scores, _ = agent_state.params(obs)
    arms = obs[PER_ARM_FEATURE_KEY]
    unit = arms / (torch.linalg.vector_norm(arms, dim=-1, keepdim=True)
                   + 1e-8)
    chosen = torch.zeros_like(scores, dtype=torch.bool)
    penalty, gaps = torch.zeros_like(scores), []
    for _ in range(policy.slate_size):
      eff = torch.where(chosen, -1e9, scores
                        - policy.diversity_penalty * penalty)
      gaps.append(_score_gaps(eff) * float(eff.abs().max())
                  / float(scores.abs().max()))
      idx = torch.argmax(eff, dim=-1)
      picked = torch.gather(unit, 1, idx[:, None, None].expand(
          -1, 1, unit.shape[-1]))
      penalty = penalty + torch.abs(torch.sum(unit * picked, dim=-1))
      chosen = chosen | torch.nn.functional.one_hot(
          idx, scores.shape[-1]).bool()
    return torch.stack(gaps).min(dim=0).values


def phase_bandit_parity(card):
  """Each scenario's rounds on the CPU from a recorded generator, each
  repeated on the card from the CPU's state with the CPU's draws: the
  collect (actions by the gap rule, the rest on the agreeing rows) and the
  train step on the CPU's round."""
  import torch

  from agents_tpu_torch.utils import nest_utils
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws
  from examples import bandits_train_eval_torch as example

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  rtol, atol = 1e-5, 1e-6
  out, ok = {}, True
  for scenario in BANDIT_SCENARIOS:
    cloop, _, _ = example.build_loop(bandit_config("cpu"), scenario)
    gloop, _, _ = example.build_loop(bandit_config("cuda"), scenario)
    draws = RecordingDraws(Draws(0, "cpu"))
    cstate, _ = cloop.run(cloop.init(draws=draws), BANDIT_PARITY_WARMUP)
    gstate = gloop.init(seed=0)
    diffs, mismatched, parted, unclear = {}, [], 0, 0

    def compare(tag, card_value, cpu_value):
      a, b = card_value.detach().cpu(), cpu_value.detach().cpu()
      if a.dtype.is_floating_point:
        diffs[tag] = max_diff(a, b)
        if not torch.allclose(a, b, rtol=rtol, atol=atol):
          mismatched.append(tag)
      elif not torch.equal(a, b):
        mismatched.append(tag)

    for r in range(1, BANDIT_PARITY_ROUNDS + 1):
      seen = record_counts(draws)
      time_step = cstate.driver_state.time_step
      c_after, c_exp = cloop.collect(cstate)   # leaves the agent as it was
      records = new_records(draws, seen)
      gaps = bandit_decision_gaps(scenario, cloop.agent, cstate.agent_state,
                                  time_step, records)
      # The card collects from the CPU's state with the CPU's draws (its
      # agent loaded before the CPU's train step updates the CPU's
      # networks in place).
      gagent = load_agent_state(gstate.agent_state, cstate.agent_state)
      gstate = dataclasses.replace(
          gstate, agent_state=gagent,
          driver_state=to_device(cstate.driver_state, "cuda"),
          metric_states=to_device(cstate.metric_states, "cuda"),
          draws=ReplayDraws(records, "cuda"))
      g_after, g_exp = gloop.collect(gstate)
      c_act = c_exp.action[:, 0].reshape(c_exp.action.shape[0], -1)
      g_act = g_exp.action[:, 0].cpu().reshape(c_act.shape)
      agree = (c_act == g_act).all(dim=-1)
      clear = gaps > BANDIT_GAP
      unclear += int((~clear).sum())
      if not bool(agree[clear].all()):
        mismatched.append(f"round{r}.actions")
      parted += int((~agree).sum())
      rows = agree.nonzero()[:, 0]
      for i, (a, b) in enumerate(zip(nest_utils.flatten(g_exp),
                                     nest_utils.flatten(c_exp))):
        compare(f"round{r}.experience.{i}", a.cpu()[rows], b[rows])
      compare(f"round{r}.env.round", g_after.driver_state.env_state.round,
              c_after.driver_state.env_state.round)
      for i, (a, b) in enumerate(zip(
          nest_utils.flatten(g_after.driver_state.env_state.context),
          nest_utils.flatten(c_after.driver_state.env_state.context))):
        compare(f"round{r}.env.context.{i}", a, b)
      if bool(agree.all()):
        for i, (a, b) in enumerate(zip(nest_utils.flatten(
            g_after.metric_states), nest_utils.flatten(
                c_after.metric_states))):
          compare(f"round{r}.metrics.{i}", a, b)
      # The train step: the card's on the CPU's round, from the CPU's state.
      c_agent, c_info = cloop.agent.train(c_after.agent_state, c_exp)
      g_agent, g_info = gloop.agent.train(g_after.agent_state,
                                          to_device(c_exp, "cuda"))
      compare(f"round{r}.loss", g_info.loss, c_info.loss)
      ctensors, gtensors = state_tensors(c_agent), state_tensors(g_agent)
      if set(ctensors) != set(gtensors):
        mismatched.append(f"round{r}.agent_state.names")
      for k in ctensors:
        compare(f"round{r}.{k}", gtensors[k], ctensors[k])
      cstate = dataclasses.replace(c_after, agent_state=c_agent)
      gstate = dataclasses.replace(g_after, agent_state=g_agent)
    worst = max(diffs, key=diffs.get) if diffs else None
    case_ok = not mismatched
    ok = ok and case_ok
    out[scenario] = {"rounds": BANDIT_PARITY_ROUNDS,
                     "after_cpu_rounds": BANDIT_PARITY_WARMUP,
                     "rows_with_unclear_decisions": unclear,
                     "rows_whose_actions_parted": parted,
                     "largest_float_diff": {"name": worst,
                                            "abs": diffs.get(worst)},
                     "compared": len(diffs), "mismatched": mismatched[:10],
                     "ok": case_ok}
    del cloop, gloop, cstate, gstate
  emit("bandit_parity", card=card, scenarios=out,
       batch_size=bandit_config("cpu").env_batch_size,
       tolerance=f"floats rtol {rtol} / atol {atol}; actions equal where "
       f"the CPU's top two scores lie more than {BANDIT_GAP} max|score| "
       "apart", ok=ok)
  if not ok:
    fail("bandit_parity", "the card left the CPU")


def phase_bandit_main(card):
  """Each scenario at B=256: a sync-checked stretch of rounds, finite
  losses and metrics, the train step counted."""
  import torch

  from examples import bandits_train_eval_torch as example

  out, ok = {}, True
  for scenario in BANDIT_SCENARIOS:
    cfg = bandit_config("cuda")
    loop, _, _ = example.build_loop(cfg, scenario)
    state = loop.init(seed=0)
    state, _ = loop.run(state, BANDIT_WARMUP)
    try:
      state, losses = sync_checked(loop.run, state, BANDIT_CHECKED)
      sync_free = True
    except RuntimeError as e:
      sync_free, losses = str(e)[:300], None
    results = {k: float(v) for k, v in loop.results(state).items()}
    case_ok = (sync_free is True and losses is not None
               and bool(torch.isfinite(losses).all())
               and all(math.isfinite(v) for v in results.values())
               and state.agent_state.train_step
               == BANDIT_WARMUP + BANDIT_CHECKED)
    ok = ok and case_ok
    out[scenario] = {"sync_free": sync_free, "metrics": results,
                     "ok": case_ok}
    del loop, state
  emit("bandit_main", card=card, batch_size=bandit_config("cuda")
       .env_batch_size, checked_rounds=BANDIT_CHECKED, scenarios=out, ok=ok)
  if not ok:
    fail("bandit_main", "a scenario was not sync-free or not finite")


def phase_bandit_learn(card):
  """`linucb_stationary` and `neural_eps_greedy` for the example's 1,000
  rounds against the JAX package's bars."""
  from examples import bandits_train_eval_torch as example

  out, ok = {}, True
  for scenario in BANDIT_LEARN:
    cfg = bandit_config("cuda")
    _, records = example.train_eval(cfg, scenario)
    last, bar = records[-1], BANDIT_LEARN_BARS[scenario]
    case_ok = (last["round"] == cfg.num_rounds
               and last["RegretMetric"] <= bar["regret"]
               and last["SuboptimalArmsMetric"] <= bar["suboptimal_arms"])
    ok = ok and case_ok
    # The example's records, less its `rounds_per_s`.
    out[scenario] = {"records": [{k: v for k, v in r.items()
                                  if k != "rounds_per_s"} for r in records],
                     "bar": bar, "ok": case_ok}
  emit("bandit_learn", card=card, scenarios=out, ok=ok)
  if not ok:
    fail("bandit_learn", "a scenario ended above the JAX package's bar")


def phase_bandit_scenarios(card):
  """Every scenario of the example through `train_eval` for a short run."""
  from examples import bandits_train_eval_torch as example

  out, ok = {}, True
  for scenario in example.SCENARIOS:
    cfg = bandit_config("cuda", num_rounds=BANDIT_SCENARIO_ROUNDS,
                        log_interval=BANDIT_SCENARIO_LOG)
    state, records = example.train_eval(cfg, scenario)
    path = os.path.join(cfg.root_dir, f"{scenario}.jsonl")
    with open(path) as f:
      written = [json.loads(line) for line in f]
    finite = all(math.isfinite(v) for rec in records for k, v in rec.items()
                 if k != "scenario")
    case_ok = (written == records and finite
               and records[-1]["round"] == BANDIT_SCENARIO_ROUNDS
               and state.agent_state.train_step == BANDIT_SCENARIO_ROUNDS)
    ok = ok and case_ok
    out[scenario] = {"last": {k: v for k, v in records[-1].items()
                              if k != "rounds_per_s"}, "ok": case_ok}
  emit("bandit_scenarios", card=card, rounds=BANDIT_SCENARIO_ROUNDS,
       scenarios=out, ok=ok)
  if not ok:
    fail("bandit_scenarios", "a scenario failed its short run")


def bandit_phases(card):
  """The bandit slice's parity and sync-checked rounds; its learning and
  scenario runs (`phase_bandit_learn`, `phase_bandit_scenarios`) are in
  `UNTIMED_PHASES`."""
  phase_bandit_parity(card)
  free_card()
  phase_bandit_main(card)
  free_card()


# (a)'s sorted loop: its sync-checked stretch two periods of the target
# update (every 5).
SURFACE_WARMUP, SURFACE_CHECKED = 20, 10
SURFACE_SAMPLE_STEPS = 2
SURFACE_BTS_ROUNDS = 200
SURFACE_KS_ALPHAS, SURFACE_KS_N, SURFACE_KS_P = (0.5, 1.0, 5.0, 50.0), \
    100_000, 1e-3


def well_conditioned_rows(dist, action, log_prob, rtol=RTOL, atol=ATOL):
  """The rows whose log-probability moves by less than the tolerance when
  the action moves by one part in a million: a policy's log-probability
  is its distribution's `log_prob` of the sampled action, and a
  tanh-squashed action goes back through atanh, so near the bounds or
  under a small scale an ulp of the action moves it far, and two float32
  evaluations part for that reason alone."""
  import torch

  a = action.detach().clone().requires_grad_()
  (grad,) = torch.autograd.grad(dist.log_prob(a).sum(), a)
  moved = (grad.abs() * a.detach().abs()).reshape(len(a), -1).sum(-1) * 1e-6
  return moved < atol + rtol * log_prob.abs()


def surface_sorted_sample():
  """(a) of `phase_surface`: the sorted loop's sync-checked stretch and
  its sample against the CPU's."""
  import torch

  from agents_tpu_torch import metrics
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.replay_buffers.uniform_replay import ReplayState
  from agents_tpu_torch.train import FusedTrainLoop
  from agents_tpu_torch.utils import nest_utils
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws

  base = build_loop("cuda", B_MAIN, **MAIN)
  replay = UniformReplay(base.replay.data_spec, B_MAIN, MAIN["capacity"],
                         sort_for_locality=True, device="cuda")
  srt = FusedTrainLoop(base.env, base.agent, replay,
                       metrics=metrics.standard_collect_metrics(20),
                       sample_batch_size=MAIN["sample_batch_size"],
                       device="cuda")
  state = srt.init(seed=0, initial_collect_steps=100)
  state, _ = srt.run(state, SURFACE_WARMUP)
  state, losses = sync_checked(srt.run, state, SURFACE_CHECKED)
  finite = bool(torch.isfinite(losses).all())

  recorded = RecordingDraws(Draws(1, "cuda"))
  rstate = state.replay_state
  batch, info = replay.sample(rstate, recorded, MAIN["sample_batch_size"],
                              SURFACE_SAMPLE_STEPS)
  cpu_replay = UniformReplay(replay.data_spec, B_MAIN, MAIN["capacity"],
                             sort_for_locality=True, device="cpu")
  cpu_state = ReplayState(storage=nest_utils.tree_map(
      lambda x: x.cpu(), rstate.storage), count=rstate.count)
  cpu_batch, cpu_info = cpu_replay.sample(
      cpu_state, ReplayDraws(recorded.records), MAIN["sample_batch_size"],
      SURFACE_SAMPLE_STEPS)
  flat = info.ids * B_MAIN + info.rows
  equal = (torch.equal(info.ids.cpu(), cpu_info.ids)
           and torch.equal(info.rows.cpu(), cpu_info.rows)
           and all(torch.equal(a.cpu(), b) for a, b in zip(
               nest_utils.flatten(batch), nest_utils.flatten(cpu_batch)))
           and bool((flat[1:] >= flat[:-1]).all()))
  return {
      "batch_size": B_MAIN, **{k: list(v) if isinstance(v, tuple) else v
                               for k, v in MAIN.items()},
      "checked_iterations": SURFACE_CHECKED,
      "losses_finite": finite, "sample_equal_to_cpu": equal,
      "ok": finite and equal}


def surface_helpers():
  """(b) of `phase_surface`: the new helpers on "cuda" against "cpu"."""
  import copy

  import numpy as np
  import torch

  from agents_tpu_torch.networks import make_sac_actor_network
  from agents_tpu_torch.ops import replay_gather
  from agents_tpu_torch.policies import ActorPolicy
  from agents_tpu_torch.specs import array_spec
  from agents_tpu_torch.trajectories import time_step as ts
  from agents_tpu_torch.utils import common, nest_utils, tensor_normalizer
  from agents_tpu_torch.utils.draws import ReplayDraws

  rng = np.random.default_rng(11)
  out = {}
  both = lambda x: {d: torch.from_numpy(x).to(d)  # noqa: E731
                    for d in ("cpu", "cuda")}

  q = both(rng.standard_normal((B_MAIN, 6, 5)).astype(np.float32))
  acts = both(np.stack([rng.integers(0, 6, B_MAIN),
                        rng.integers(0, 5, B_MAIN)], -1).astype(np.int32))
  got = {d: common.index_with_actions(q[d], acts[d], multi_dim_actions=True)
         for d in q}
  out["index_with_actions"] = {"equal": torch.equal(got["cuda"].cpu(),
                                                    got["cpu"])}

  obs_spec = array_spec.BoundedArraySpec((3,), np.float32, -8.0, 8.0)
  act_spec = array_spec.BoundedArraySpec((1,), np.float32, -2.0, 2.0)
  generator = torch.Generator().manual_seed(5)
  net = make_sac_actor_network(obs_spec, act_spec, fc_layer_params=(256, 256),
                               device="cpu", generator=generator)
  nets = {"cpu": net, "cuda": copy.deepcopy(net).to("cuda")}
  tss = ts.time_step_spec(obs_spec)
  batch = 32
  theta = rng.uniform(-np.pi, np.pi, batch)
  obs = both(np.stack([np.cos(theta), np.sin(theta),
                       rng.uniform(-8, 8, batch)], 1).astype(np.float32))
  noise = rng.standard_normal((batch, 1)).astype(np.float32)
  steps = {}
  for d, n in nets.items():
    policy = ActorPolicy(tss, act_spec, n, emit_log_probability=True)
    with torch.no_grad():
      steps[d] = policy.action(n, ts.restart(obs[d], batch), (), ReplayDraws(
          {"actor_noise": [noise]}, device=d))
  lp = {d: s.info.log_probability for d, s in steps.items()}
  rows = well_conditioned_rows(
      policy.distribution(net, ts.restart(obs["cpu"], batch)).action,
      steps["cpu"].action, lp["cpu"])
  lp_diff = (lp["cuda"].cpu() - lp["cpu"]).abs()
  out["actor_log_probability"] = {
      "actions_max_abs_diff": max_diff(steps["cuda"].action.cpu(),
                                       steps["cpu"].action),
      "rows_compared": int(rows.sum()), "rows": batch,
      "log_prob_max_abs_diff": float(lp_diff[rows].max()),
      "log_prob_max_abs_diff_all_rows": float(lp_diff.max()),
      "equal": (torch.allclose(steps["cuda"].action.cpu(),
                               steps["cpu"].action, RTOL, ATOL)
                and int(rows.sum()) >= batch // 3
                and torch.allclose(lp["cuda"].cpu()[rows], lp["cpu"][rows],
                                   RTOL, ATOL))}

  spec = array_spec.ArraySpec((3,), np.float32)
  norm = tensor_normalizer.StreamingTensorNormalizer(spec)
  states = {d: norm.init(d) for d in ("cpu", "cuda")}
  for _ in range(3):
    x = both((rng.standard_normal((B_MAIN, 8, 3)) * 3 + 1).astype(
        np.float32))
    states = {d: norm.update(s, x[d], outer_dims=(0, 1))
              for d, s in states.items()}
  out["normalizer_outer_dims"] = {"equal": all(
      torch.allclose(a.cpu(), b, RTOL, ATOL) for a, b in zip(
          nest_utils.flatten(states["cuda"]),
          nest_utils.flatten(states["cpu"])))}

  frames = rng.integers(0, 256, (256, 84 * 84 * 4)).astype(np.uint8)
  x = both(frames)
  packed = {d: replay_gather.pack_rows(v) for d, v in x.items()}
  out["pack_rows"] = {
      "packed_shape": list(packed["cuda"].shape),
      "equal": (torch.equal(packed["cuda"].cpu(), packed["cpu"])
                and torch.equal(replay_gather.unpack_rows(
                    packed["cuda"], frames.shape[1]).cpu(), x["cpu"]))}
  ok = all(v["equal"] for v in out.values())
  return out, ok


def surface_bernoulli_ts(root):
  """(c) of 5h: Bernoulli Thompson sampling trained, saved, reloaded and
  acting as the live policy; the gamma transform's KS tests."""
  import importlib.util

  import numpy as np
  import scipy.stats
  import torch

  from agents_tpu_torch.policies.policy_saver import (PolicySaver,
                                                      load_manifest,
                                                      load_policy)
  from agents_tpu_torch.trajectories import time_step as ts
  from agents_tpu_torch.utils import draws as draws_lib
  from examples import bandits_train_eval_torch as example

  cfg = bandit_config("cuda", num_rounds=SURFACE_BTS_ROUNDS,
                      log_interval=SURFACE_BTS_ROUNDS)
  loop, env, _ = example.build_loop(cfg, "bernoulli_ts")
  state, _ = loop.run(loop.init(seed=cfg.seed), SURFACE_BTS_ROUNDS)
  agent, posterior = loop.agent, state.agent_state
  export = os.path.join(root, "bernoulli_ts")
  PolicySaver(agent.policy, train_step=posterior.train_step).save(
      export, posterior)
  manifest = json.load(open(os.path.join(export,
                                         "exported_manifest.json")))
  restored = load_policy(export, policy=agent.policy,
                         params_template=agent.init(), device="cuda")
  batch = cfg.env_batch_size
  obs = np.zeros((batch,) + env.observation_spec().shape,
                 env.observation_spec().dtype)
  actions, report = artifact_actions("surface", export, obs, root)
  spec = importlib.util.spec_from_file_location(
      "bts_loader", os.path.join(export, "loader.py"))
  loader = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(loader)
  inputs = loader.ExportedPolicy(export, platform="cpu").draw_inputs(
      batch, np.zeros((2,), np.uint32))
  apart = {}
  for d in ("cuda", "cpu"):
    params = type(posterior)(alpha=posterior.alpha.to(d),
                             beta=posterior.beta.to(d),
                             train_step=posterior.train_step)
    step = ts.TimeStep(
        step_type=torch.ones(batch, dtype=torch.int32, device=d),
        reward=torch.zeros(batch, device=d),
        discount=torch.ones(batch, device=d),
        observation=torch.from_numpy(obs).to(d))
    with torch.no_grad():
      live = agent.policy.action(params, step, (), draws_lib.InputDraws(
          manifest["draw_sites"], [torch.from_numpy(x).to(d)
                                   for x in inputs], d)).action
    apart[d] = int((live.cpu().numpy() != actions[d]).sum())

  rng = np.random.default_rng(14)
  rounds = draws_lib.GAMMA_ROUNDS
  ks = {}
  for alpha in SURFACE_KS_ALPHAS:
    n = SURFACE_KS_N
    raw = np.concatenate([rng.standard_normal((rounds, n)),
                          rng.random((rounds + 1, n))]).astype(np.float32)
    g = draws_lib.marsaglia_tsang_gamma(
        torch.full((n,), alpha, device="cuda"),
        torch.from_numpy(raw).to("cuda")).cpu().numpy()
    ks[str(alpha)] = float(scipy.stats.kstest(
        g, scipy.stats.gamma(alpha).cdf).pvalue)
  out = {
      "rounds": SURFACE_BTS_ROUNDS, "batch_size": batch,
      "alpha": posterior.alpha.tolist(), "beta": posterior.beta.tolist(),
      "export": load_manifest(export)["torch_export"],
      "platforms": manifest["platforms"],
      "draw_sites": manifest["draw_sites"],
      "restored": (torch.equal(restored.params.alpha, posterior.alpha)
                   and torch.equal(restored.params.beta, posterior.beta)),
      "actions_apart": apart, "child_leaked": report["leaked"],
      "action_counts": np.bincount(actions["cuda"],
                                   minlength=len(posterior.alpha)).tolist(),
      "gamma_ks_pvalues": ks}
  ok = (out["export"] == "batch-polymorphic"
        and sorted(out["platforms"]) == ["cpu", "cuda"]
        and [s["kind"] for s in out["draw_sites"]] == ["beta"]
        and out["restored"] and not report["leaked"]
        and all(v == 0 for v in apart.values())
        and all(p > SURFACE_KS_P for p in ks.values()))
  return out, ok


def phase_surface(card):
  """(a) the sorted sample at the bench point and (b) the new helpers card
  against CPU (see 5h above)."""
  import torch

  matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    sorted_sample = surface_sorted_sample()
    free_card()
    helpers, helpers_ok = surface_helpers()
  finally:
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
  ok = sorted_sample["ok"] and helpers_ok
  emit("surface", card=card, sorted_sample=sorted_sample, helpers=helpers,
       ok=ok)
  if not ok:
    fail("surface", "a surface check failed")


def phase_surface_bernoulli_ts(card):
  """(c) of 5h: Bernoulli Thompson sampling's export, in a child process
  beside the learning runs."""
  os.makedirs(RUNS_DIR, exist_ok=True)
  root = tempfile.mkdtemp(prefix="surface_", dir=RUNS_DIR)
  try:
    bts, ok = surface_bernoulli_ts(root)
  finally:
    shutil.rmtree(root, ignore_errors=True)
  emit("surface_bernoulli_ts", card=card, **bts, ok=ok)
  if not ok:
    fail("surface_bernoulli_ts", "a Bernoulli Thompson sampling check "
         "failed")


def phase_conv_parity(card):
  import numpy as np
  import torch

  from agents_tpu_torch.environments.classic import SyntheticPixels
  from agents_tpu_torch.networks import make_q_network
  from agents_tpu_torch.utils import convert
  from examples.dqn_pixels_torch import Config
  from examples.dqn_pixels_torch import build_loop as pixel_loop

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  deterministic = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True

  # (a) the pixel loop, fp32, card against CPU.
  size = CONV_PARITY["pixels_size"]
  state_dict = convert.q_params_to_state_dict(numpy_q_params(
      np.random.RandomState(1), (512,), num_actions=6, convs=MNIH15,
      image=(size, size, 4)))
  runs = run_on_both(lambda device: pixel_loop(Config(device=device,
                                                       **CONV_PARITY)),
                     lambda loop: loop.agent.q_network.load_state_dict(
                         state_dict),
                     initial_collect_steps=16, iterations=3)
  diffs, mismatched = compare_runs(runs, CONV_RTOL, CONV_ATOL)
  worst = max(diffs, key=diffs.get)
  storage = runs["cuda"][1].replay_state.storage
  torch.backends.cudnn.deterministic = deterministic

  # (b) the bf16 bench network on 32 random 84x84x4 frames.
  rng = np.random.RandomState(2)
  state_dict = convert.q_params_to_state_dict(numpy_q_params(
      rng, (512,), num_actions=6, convs=MNIH15, image=(84, 84, 4)))
  frames = torch.from_numpy(rng.randint(0, 256, (32, 84, 84, 4), np.uint8))
  env = SyntheticPixels()
  q = {}
  for device in ("cpu", "cuda"):
    net = make_q_network(
        env.observation_spec(), env.action_spec(), MNIH15, (512,),
        dtype=torch.bfloat16,
        preprocessing=lambda x: x.to(torch.bfloat16) / 255.0, device=device)
    net.load_state_dict(state_dict)
    with torch.no_grad():
      q[device] = net(frames.to(device))[0].cpu()
  q_diff = max_diff(q["cpu"], q["cuda"])
  top2 = q["cpu"].topk(2, dim=-1).values
  clear = (top2[:, 0] - top2[:, 1]) > BF16_ATOL
  action_mismatch = int((q["cpu"].argmax(-1) != q["cuda"].argmax(-1))[
      clear].sum())
  ok = not mismatched and q_diff <= BF16_ATOL and action_mismatch == 0
  emit("conv_parity", card=card,
       fp32={"pixels": f"{size}x{size}x4", "conv": MNIH15, "fc": [512],
             "batch_size": CONV_PARITY["env_batch_size"],
             "ring": CONV_PARITY["replay_capacity"],
             "sample": CONV_PARITY["sample_batch_size"], "iterations": 3,
             "rtol": CONV_RTOL, "atol": CONV_ATOL,
             "largest_float_diff": {"name": worst, "abs": diffs[worst]},
             "loss_diff": diffs["losses"],
             "replay_observation_dtype": str(storage.observation.dtype),
             "mismatched": mismatched},
       bf16={"frames": 32, "atol": BF16_ATOL, "q_max_abs_diff": q_diff,
             "frames_with_top2_gap_over_atol": int(clear.sum()),
             "greedy_action_mismatches": action_mismatch}, ok=ok)
  if not ok:
    fail("conv_parity", "card and CPU disagree on the conv path")


def phase_conv_main(card):
  import torch

  from examples.dqn_pixels_torch import Config
  from examples.dqn_pixels_torch import build_loop as pixel_loop

  cfg = Config()
  torch.cuda.reset_peak_memory_stats()
  loop = pixel_loop(cfg)
  state = loop.init(seed=cfg.seed, initial_collect_steps=CONV_INITIAL)
  state, losses = loop.run(state, CONV_WARMUP)
  state, losses = sync_checked(loop.run, state, CONV_CHECKED)
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  finite = bool(torch.isfinite(losses).all())
  expected_count = CONV_INITIAL + CONV_WARMUP + CONV_CHECKED
  bad_transitions, lasts = check_step_types(loop, state)
  replay_count = state.replay_state.count
  obs = state.replay_state.storage.observation
  obs_bytes = obs.numel() * obs.element_size()
  expected_bytes = (cfg.replay_capacity * cfg.env_batch_size
                    * cfg.pixels_size ** 2 * cfg.pixels_frames)
  ok = (not off_card and finite and bad_transitions == 0
        and replay_count == expected_count and obs.dtype == torch.uint8
        and obs_bytes == expected_bytes)
  emit("conv_main", card=card, batch_size=cfg.env_batch_size,
       sample_batch_size=cfg.sample_batch_size, ring=cfg.replay_capacity,
       conv=cfg.conv_layer_params, fc=cfg.fc_layer_params, dtype=cfg.dtype,
       checked_iterations=CONV_CHECKED, sync_debug_mode="error",
       tensors_off_card=off_card,
       losses_finite=finite, replay_count=replay_count,
       expected_replay_count=expected_count,
       replay_observation={"dtype": str(obs.dtype), "shape": list(obs.shape),
                           "bytes": obs_bytes,
                           "expected_bytes": expected_bytes},
       illegal_step_type_transitions=bad_transitions,
       last_frames_in_ring=lasts,
       peak_memory_allocated_bytes=torch.cuda.max_memory_allocated(), ok=ok)
  if not ok:
    fail("conv_main", "pixel bench point checks failed")


def phase_conv_learn(card):
  import torch

  from examples.dqn_pixels_torch import CATCH, Config
  from examples.dqn_pixels_torch import build_loop as pixel_loop

  cfg = Config(**CATCH)
  loop = pixel_loop(cfg)
  state = loop.init(seed=cfg.seed,
                    initial_collect_steps=cfg.initial_collect_steps)
  iterations, ret = 0, -1.0
  while iterations < CATCH_ITERATIONS:
    state, losses = loop.run(state, CATCH_CHUNK)
    iterations += CATCH_CHUNK
    ret = float(loop.results(state)["AverageReturn"])
    if ret > 0.5:
      break
  out = loop.evaluate(state, cfg.seed + 101, num_episodes=30, max_steps=2000)
  episodes = int(out["NumberOfEpisodes"])
  finite = bool(torch.isfinite(losses).all())
  ok = ret > CATCH_GATE and finite and episodes == 30
  emit("conv_learn", card=card, env=f"catch {cfg.catch_rows}x"
       f"{cfg.catch_columns}", batch_size=cfg.env_batch_size,
       iterations=iterations, last100_average_return=ret, gate=CATCH_GATE,
       losses_finite=finite, eval_episodes=episodes,
       eval_average_return=float(out["AverageReturn"]), ok=ok)
  if not ok:
    fail("conv_learn", f"Catch return {ret} (gate {CATCH_GATE}), "
         f"{episodes} eval episodes of 30")


def phase_c51(card):
  import torch

  from examples.dqn_pixels_torch import Config
  from examples.dqn_pixels_torch import build_loop as pixel_loop

  cfg = Config(agent="c51")
  loop = pixel_loop(cfg)
  state = loop.init(seed=cfg.seed, initial_collect_steps=CONV_INITIAL)
  state, losses = loop.run(state, C51_WARMUP)
  state, losses = sync_checked(loop.run, state, C51_CHECKED)
  finite = bool(torch.isfinite(losses).all())
  expected_count = CONV_INITIAL + C51_WARMUP + C51_CHECKED
  ok = finite and state.replay_state.count == expected_count
  emit("c51", card=card, num_atoms=cfg.num_atoms,
       support=[cfg.min_q_value, cfg.max_q_value],
       batch_size=cfg.env_batch_size, sample_batch_size=cfg.sample_batch_size,
       ring=cfg.replay_capacity, checked_iterations=C51_CHECKED,
       sync_debug_mode="error", losses_finite=finite,
       last_loss=float(losses[-1]), replay_count=state.replay_state.count,
       expected_replay_count=expected_count, ok=ok)
  if not ok:
    fail("c51", "C51 at the pixel bench point failed its checks")


def numpy_sac_params(rng, actor_fc, critic_fc, obs_dim=3, act_dim=1):
  """Flax-shaped SAC actor and two critic param trees drawn with numpy."""
  import numpy as np

  def layer(shape, scale):
    return {"kernel": rng.uniform(-scale, scale, shape).astype(np.float32),
            "bias": rng.uniform(-0.05, 0.05, shape[-1:]).astype(np.float32)}

  def stack(width, widths):
    layers = []
    for out in widths:
      layers.append(layer((width, out), math.sqrt(3.0 / width)))
      width = out
    return layers, width

  encoder, width = stack(obs_dim, actor_fc)
  actor = {"params": {
      "EncoderModule_0": {f"Dense_{i}": d for i, d in enumerate(encoder)},
      "TanhNormalProjection_0": {"Dense_0": layer(
          (width, 2 * act_dim), math.sqrt(3.0 / width))}}}

  def critic():
    layers, width = stack(obs_dim + act_dim, critic_fc)
    layers.append(layer((width, 1), 0.003))
    return {"params": {f"Dense_{i}": d for i, d in enumerate(layers)}}

  return actor, critic(), critic()


def phase_sac_parity(card):
  import numpy as np
  import torch

  from agents_tpu_torch.utils import convert
  from examples.sac_pendulum_torch import Config
  from examples.sac_pendulum_torch import build_loop as sac_loop

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cfg = Config(**SAC_PARITY)
  actor, critic1, critic2 = numpy_sac_params(
      np.random.RandomState(3), cfg.actor_fc_layers,
      cfg.critic_joint_fc_layers)

  def load(loop):
    agent = loop.agent
    agent.actor_network.load_state_dict(
        convert.sac_actor_params_to_state_dict(actor))
    agent.critic_network.load_state_dict(
        convert.sac_critic_params_to_state_dict(critic1))
    agent.critic_network_2.load_state_dict(
        convert.sac_critic_params_to_state_dict(critic2))

  runs = run_on_both(
      lambda device: sac_loop(dataclasses.replace(cfg, device=device)),
      load, initial_collect_steps=16, iterations=3)
  diffs, mismatched = compare_runs(runs, SAC_RTOL, SAC_ATOL,
                                    state_tensors)
  worst = max(diffs, key=diffs.get)
  gstate = runs["cuda"][1]
  ok = not mismatched and gstate.agent_state.train_step == 3 * 2
  emit("sac_parity", card=card, actor=list(cfg.actor_fc_layers),
       critic=list(cfg.critic_joint_fc_layers),
       batch_size=cfg.env_batch_size, ring=cfg.replay_capacity,
       sample=cfg.sample_batch_size,
       train_steps_per_iteration=cfg.train_steps_per_iteration,
       iterations=3, rtol=SAC_RTOL, atol=SAC_ATOL,
       largest_float_diff={"name": worst, "abs": diffs[worst]},
       loss_diff=diffs["losses"], log_alpha_diff=diffs["log_alpha"],
       compared=len(diffs), mismatched=mismatched, ok=ok)
  if not ok:
    fail("sac_parity", f"card and CPU disagree on {mismatched}")


def phase_sac_main(card):
  import torch

  from examples.sac_pendulum_torch import Config
  from examples.sac_pendulum_torch import build_loop as sac_loop

  cfg = Config()
  loop = sac_loop(cfg)
  state = loop.init(seed=cfg.seed,
                    initial_collect_steps=cfg.initial_collect_steps)
  state, losses = loop.run(state, SAC_WARMUP)
  state, losses = sync_checked(loop.run, state, SAC_CHECKED)
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  log_alpha = float(state.agent_state.log_alpha.detach())
  finite = bool(torch.isfinite(losses).all()) and math.isfinite(log_alpha)
  expected_count = cfg.initial_collect_steps + SAC_WARMUP + SAC_CHECKED
  bad_transitions, lasts = check_step_types(loop, state)
  replay_count = state.replay_state.count
  expected_steps = (SAC_WARMUP + SAC_CHECKED) * cfg.train_steps_per_iteration
  ok = (not off_card and finite and bad_transitions == 0
        and replay_count == expected_count
        and state.agent_state.train_step == expected_steps)
  emit("sac_main", card=card, batch_size=cfg.env_batch_size,
       ring=cfg.replay_capacity, sample_batch_size=cfg.sample_batch_size,
       actor=list(cfg.actor_fc_layers), critic=list(cfg.critic_joint_fc_layers),
       train_steps_per_iteration=cfg.train_steps_per_iteration,
       checked_iterations=SAC_CHECKED, sync_debug_mode="error",
       tensors_off_card=off_card,
       losses_finite=finite, last_loss=float(losses[-1]),
       log_alpha=log_alpha, replay_count=replay_count,
       expected_replay_count=expected_count,
       train_step=state.agent_state.train_step,
       illegal_step_type_transitions=bad_transitions,
       last_frames_in_ring=lasts, ok=ok)
  if not ok:
    fail("sac_main", "SAC bench point checks failed")


def phase_sac_learn(card):
  import torch

  from examples.sac_pendulum_torch import LIVE, Config
  from examples.sac_pendulum_torch import build_loop as sac_loop

  window = live_window("SAC_PENDULUM_LIVE")
  budget, gate = window.step_budget, window.min_return
  cfg = Config(**LIVE)
  loop = sac_loop(cfg)
  state = loop.init(seed=cfg.seed,
                    initial_collect_steps=cfg.initial_collect_steps)
  iterations, ret, points = 0, -math.inf, []
  while iterations < budget:
    state, losses = loop.run(state, SAC_LEARN_CHUNK)
    iterations += SAC_LEARN_CHUNK
    ret = float(loop.results(state)["AverageReturn"])
    points.append([iterations, ret])
    if ret >= gate:
      break
  out = loop.evaluate(state, cfg.seed + 101, num_episodes=30, max_steps=2000)
  episodes = int(out["NumberOfEpisodes"])
  eval_return = float(out["AverageReturn"])
  finite = bool(torch.isfinite(losses).all())
  ok = ret >= gate and finite and episodes == 30
  emit("sac_learn", card=card, batch_size=cfg.env_batch_size,
       sample_batch_size=cfg.sample_batch_size,
       train_steps_per_iteration=cfg.train_steps_per_iteration,
       actor=list(cfg.actor_fc_layers), critic=list(cfg.critic_joint_fc_layers),
       iterations=iterations, last20_average_return=ret,
       gate=gate, points=points, losses_finite=finite,
       log_alpha=float(state.agent_state.log_alpha.detach()),
       eval_episodes=episodes, eval_average_return=eval_return, ok=ok)
  if not ok:
    fail("sac_learn", f"last-20 return {ret} (gate {gate}), "
         f"{episodes} eval episodes of 30")


def numpy_ppo_params(rng, fc, obs_dim, num_actions=None, act_dim=None,
                     std_bias=0.0):
  """Flax-shaped PPO actor and value trees drawn with numpy: a categorical
  head over `num_actions`, or a Normal head of `act_dim` with a
  state-independent `std_bias`."""
  import numpy as np

  def layer(shape, scale):
    return {"kernel": rng.uniform(-scale, scale, shape).astype(np.float32),
            "bias": rng.uniform(-0.05, 0.05, shape[-1:]).astype(np.float32)}

  def encoder():
    layers, width = {}, obs_dim
    for i, out in enumerate(fc):
      layers[f"Dense_{i}"] = layer((width, out), math.sqrt(3.0 / width))
      width = out
    return layers, width

  enc, width = encoder()
  if num_actions is not None:
    head = {"CategoricalProjection_0": {"Dense_0": layer((width, num_actions),
                                                         0.1)}}
  else:
    head = {"NormalProjection_0": {
        "Dense_0": layer((width, act_dim), 0.1),
        "std_bias": np.full(act_dim, std_bias, np.float32)}}
  value_enc, width = encoder()
  return ({"params": {"EncoderModule_0": enc, **head}},
          {"params": {"EncoderModule_0": value_enc,
                      "Dense_0": layer((width, 1), 0.03)}})


def ppo_tensors(agent_state):
  """The actor and value networks' tensors, the Adam moments and step
  counts, the normalizer states, beta, the learning rate and the train
  step, by name."""
  import dataclasses

  import torch

  out = {f"{net}.{k}": v for net in ("actor_network", "value_network")
         for k, v in getattr(agent_state, net).state_dict().items()}
  optimizer = agent_state.optimizer
  params = [p for g in optimizer.param_groups for p in g["params"]]
  for i, p in enumerate(params):
    for k, v in optimizer.state[p].items():
      out[f"adam.{i}.{k}"] = v
  for field in ("obs_norm_state", "reward_norm_state"):
    state = getattr(agent_state, field)
    for f in dataclasses.fields(state):
      out[f"{field}.{f.name}"] = getattr(state, f.name)
  out["kl_beta"] = agent_state.kl_beta
  out["lr"] = torch.tensor(optimizer.param_groups[0]["lr"], dtype=torch.float64)
  out["train_step"] = torch.tensor(agent_state.train_step)
  return out


def policy_outputs(agent, agent_state, experience):
  """The collect policy's distribution parameters and value predictions
  on every frame of `experience` [B, T] (flattened to B*T rows)."""
  import torch

  from agents_tpu_torch.trajectories import time_step as ts
  from agents_tpu_torch.utils import nest_utils

  flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))  # noqa: E731
  time_step = ts.TimeStep(
      step_type=flat(experience.step_type),
      reward=flat(experience.reward), discount=flat(experience.discount),
      observation=nest_utils.tree_map(flat, experience.observation))
  with torch.no_grad():
    step = agent.collect_policy.distribution(agent.policy_params(agent_state),
                                             time_step)
  return nest_utils.flatten(step.info)


def phase_ppo_parity(card):
  """The PPO learner on the card against the CPU on the same rollouts.

  The CPU runs the loop and records its draws; for each of its rollouts
  the card computes its collect policy's outputs on the rollout's frames
  (before the train step, from its own networks) and trains on a copy of
  the rollout with the CPU's permutations. Feeding both the same rollouts
  keeps CartPole's and Pendulum's dynamics out of the comparison: over a
  rollout of 128 or 257 steps they amplify the last-bit differences of
  the card's `sin`/`cos` past any float tolerance, so a card that collects
  its own rollouts parts from the CPU.
  """
  import numpy as np
  import torch

  from agents_tpu_torch.utils import convert, nest_utils
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws
  from examples.ppo_cartpole_torch import SCHULMAN17_PENDULUM, Config
  from examples.ppo_cartpole_torch import build_loop as ppo_loop

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  out, ok = {}, True
  cases = (
      ("cartpole", Config(), PPO_PARITY_ITERATIONS,
       dict(obs_dim=4, num_actions=2)),
      ("schulman17_pendulum",
       Config(**{**SCHULMAN17_PENDULUM, **PPO_PARITY_SCHULMAN17}), 1,
       dict(obs_dim=3, act_dim=1,
            std_bias=math.log(math.exp(0.35) - 1.0))))
  for i, (name, cfg, iterations, shape) in enumerate(cases):
    actor, value = numpy_ppo_params(np.random.RandomState(5 + i),
                                    cfg.actor_fc_layers, **shape)
    loops = {}
    for role, device in (("host", "cpu"), ("card", "cuda")):
      loop = ppo_loop(dataclasses.replace(cfg, device=device))
      loop.agent.actor_network.load_state_dict(
          convert.actor_params_to_state_dict(actor))
      loop.agent.value_network.load_state_dict(
          convert.value_params_to_state_dict(value))
      loops[role] = loop
    cloop, gagent = loops["host"], loops["card"].agent
    draws = RecordingDraws(Draws(0, "cpu"))
    cstate, gstate = cloop.init(draws=draws), gagent.init()
    diffs, relative, mismatched = {}, {}, []

    def compare(tag, a, b):
      # Tensor-wise: max|a - b| <= atol + rtol * max|b|. The value targets
      # run to hundreds and their gradients to thousands, so an element
      # near zero of such a tensor carries rounding far above any
      # element-wise atol. The Adam moments sum those gradients, whose
      # first-layer sums over 508 rows cancel: rtol 1e-3 for them.
      a, b = a.cpu(), b.cpu()
      if a.dtype.is_floating_point:
        diffs[tag] = max_diff(a, b)
        scale = float(b.double().abs().max()) if b.numel() else 0.0
        relative[tag] = diffs[tag] / scale if scale else diffs[tag]
        rtol = PPO_MOMENT_RTOL if ".exp_avg" in tag else PPO_RTOL
        if diffs[tag] > PPO_ATOL + rtol * scale:
          mismatched.append(tag)
      elif not torch.equal(a, b):
        mismatched.append(tag)

    for it in range(iterations):
      cstate, experience = cloop.collect(cstate)
      gexperience = nest_utils.tree_map(lambda x: x.to("cuda"), experience)
      for j, (a, b) in enumerate(zip(
          policy_outputs(gagent, gstate, gexperience),
          policy_outputs(cloop.agent, cstate.agent_state, experience))):
        compare(f"iteration{it}.policy_info.{j}", a, b)
      cagent_state, cinfo = cloop.agent.train(cstate.agent_state, experience,
                                              draws=draws)
      cstate = dataclasses.replace(cstate, agent_state=cagent_state)
      perms = draws.records["ppo_permutation"][-cfg.num_epochs:]
      gstate, ginfo = gagent.train(
          gstate, gexperience,
          draws=ReplayDraws({"ppo_permutation": perms}, "cuda"))
      compare(f"iteration{it}.loss", cinfo.loss, ginfo.loss)
      ctensors, gtensors = (ppo_tensors(s) for s in (cagent_state, gstate))
      for k in ctensors:
        compare(f"iteration{it}.{k}", ctensors[k], gtensors[k])
    worst = max(diffs, key=diffs.get)
    worst_relative = max(relative, key=relative.get)
    case_ok = not mismatched and gstate.train_step == iterations
    ok = ok and case_ok
    out[name] = {
        "batch_size": cfg.env_batch_size, "rollout_length": cfg.rollout_length,
        "epochs": cfg.num_epochs, "minibatches": cfg.num_minibatches,
        "fc": list(cfg.actor_fc_layers), "iterations": iterations,
        "adam_steps": iterations * cfg.num_epochs * cfg.num_minibatches,
        "largest_float_diff": {"name": worst, "abs": diffs[worst]},
        "largest_relative_diff": {"name": worst_relative,
                                  "of_max_abs": relative[worst_relative]},
        "loss_diff": max(v for k, v in diffs.items() if k.endswith(".loss")),
        "policy_info_diff": max(v for k, v in diffs.items()
                                if ".policy_info." in k),
        "compared": len(diffs), "mismatched": mismatched, "ok": case_ok}
  emit("ppo_parity", card=card, rtol=PPO_RTOL, atol=PPO_ATOL,
       adam_moment_rtol=PPO_MOMENT_RTOL,
       criterion="max|card - cpu| <= atol + rtol * max|cpu| per tensor", **out,
       ok=ok)
  if not ok:
    fail("ppo_parity", "card and CPU disagree on the PPO path")


def rollout_checks(experience):
  """A rollout's legal step types (each frame's next step type is the
  following frame's step type; post-LAST is FIRST) and its shape."""
  from agents_tpu_torch.trajectories.time_step import StepType

  st, nst = experience.step_type, experience.next_step_type
  bad = int((nst[:, :-1] != st[:, 1:]).sum())
  bad += int(((st == StepType.LAST) != (nst == StepType.FIRST)).sum())
  return {"shape": list(st.shape), "illegal_step_type_transitions": bad,
          "last_frames": int((st == StepType.LAST).sum())}


def phase_ppo_main(card):
  import torch

  from examples.ppo_cartpole_torch import Config
  from examples.ppo_cartpole_torch import build_loop as ppo_loop

  cfg = Config()
  loop = ppo_loop(cfg)
  state = loop.init(cfg.seed)
  state, losses = loop.run(state, PPO_WARMUP)
  state, losses = sync_checked(loop.run, state, PPO_CHECKED)
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  finite = bool(torch.isfinite(losses).all())
  # One more iteration, collected and trained apart for its rollout.
  state, experience = loop.collect(state)
  agent_state, _ = loop.agent.train(state.agent_state, experience,
                                    draws=state.draws)
  state = dataclasses.replace(state, agent_state=agent_state)
  rollout = rollout_checks(experience)
  iterations = PPO_WARMUP + PPO_CHECKED + 1
  ok = (not off_card and finite and rollout["illegal_step_type_transitions"]
        == 0 and state.agent_state.train_step == iterations)
  emit("ppo_main", card=card, batch_size=cfg.env_batch_size,
       rollout_length=cfg.rollout_length, epochs=cfg.num_epochs,
       minibatches=cfg.num_minibatches,
       minibatch_size=cfg.env_batch_size * (cfg.rollout_length - 1)
       // cfg.num_minibatches, fc=list(cfg.actor_fc_layers),
       sync_debug_mode="error", checked_iterations=PPO_CHECKED,
       tensors_off_card=off_card, losses_finite=finite,
       last_loss=float(losses[-1]), rollout=rollout,
       train_step=state.agent_state.train_step, ok=ok)
  if not ok:
    fail("ppo_main", "PPO CartPole point checks failed")
  return cfg, loop, state, iterations


def phase_ppo_learn(card, cfg, loop, state, iterations):
  from examples.ppo_cartpole_torch import evaluate

  window = live_window("PPO_CARTPOLE_LIVE")
  budget, gate = window.step_budget, window.min_return
  ret = float(loop.results(state)["AverageReturn"])
  points = [[iterations, ret]]
  while ret < gate and iterations < budget:
    state, losses = loop.run(state, PPO_LEARN_CHUNK)
    iterations += PPO_LEARN_CHUNK
    ret = float(loop.results(state)["AverageReturn"])
    points.append([iterations, ret])
  out = evaluate(cfg, loop, state, cfg.seed + 101, 30)
  episodes = int(out["NumberOfEpisodes"])
  ok = ret >= gate and episodes == 30
  emit("ppo_learn", card=card, batch_size=cfg.env_batch_size,
       rollout_length=cfg.rollout_length, iterations=iterations,
       last20_average_return=ret, gate=gate,
       budget=budget, points=points, eval_episodes=episodes,
       eval_envs=cfg.num_eval_envs,
       eval_average_return=float(out["AverageReturn"]),
       eval_average_episode_length=float(out["AverageEpisodeLength"]), ok=ok)
  if not ok:
    fail("ppo_learn", f"last-20 return {ret} (gate {gate} within "
         f"{budget} iterations), {episodes} eval episodes of 30")


def phase_ppo_schulman17(card):
  import torch

  from examples.ppo_cartpole_torch import SCHULMAN17_PENDULUM, Config
  from examples.ppo_cartpole_torch import build_loop as ppo_loop

  cfg = Config(**SCHULMAN17_PENDULUM)
  loop = ppo_loop(cfg)
  state = loop.init(cfg.seed)
  state, losses = loop.run(state, 1)
  state, losses = sync_checked(loop.run, state, SCHULMAN17_CHECKED)
  finite = bool(torch.isfinite(losses).all())
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  iterations = SCHULMAN17_CHECKED + 1
  mb_steps = cfg.num_epochs * cfg.num_minibatches
  lr = state.agent_state.optimizer.param_groups[0]["lr"]
  expected_lr = cfg.learning_rate * (1.0 - iterations * mb_steps
                                     / (cfg.num_iterations * mb_steps))
  ok = (finite and not off_card
        and state.agent_state.train_step == iterations
        and math.isclose(lr, expected_lr, rel_tol=1e-9))
  emit("ppo_schulman17", card=card, env="pendulum (for HalfCheetah-v5)",
       batch_size=cfg.env_batch_size, rollout_length=cfg.rollout_length,
       epochs=cfg.num_epochs, minibatches=cfg.num_minibatches,
       minibatch_size=(cfg.rollout_length - 1) // cfg.num_minibatches,
       fc=list(cfg.actor_fc_layers), activation=cfg.activation,
       sync_debug_mode="error", checked_iterations=SCHULMAN17_CHECKED,
       losses=[float(x) for x in losses], losses_finite=finite,
       learning_rate=lr, expected_learning_rate=expected_lr,
       tensors_off_card=off_card, train_step=state.agent_state.train_step,
       ok=ok)
  if not ok:
    fail("ppo_schulman17", "schulman17 Pendulum point checks failed")


def build_reinforce_loop(device="cuda", seed=0):
  """REINFORCE with a (64, 64) value baseline on CartPole: B=32, T=128,
  Adam 1e-3, gamma 0.99."""
  import torch

  from agents_tpu_torch import metrics
  from agents_tpu_torch.agents.reinforce import ReinforceAgent
  from agents_tpu_torch.networks import (make_actor_distribution_network,
                                         make_value_network)
  from agents_tpu_torch.train import OnPolicyTrainLoop
  from examples.ppo_cartpole_torch import Config, build_env

  env = build_env(Config(device=device), 32)
  tss, asp = env.time_step_spec(), env.action_spec()
  generator = torch.Generator(device=device)
  generator.manual_seed(seed)
  agent = ReinforceAgent(
      tss, asp,
      make_actor_distribution_network(tss.observation, asp,
                                      fc_layer_params=(64, 64),
                                      device=device, generator=generator),
      lambda p: torch.optim.Adam(p, lr=1e-3),
      value_network=make_value_network(tss.observation, (64, 64),
                                       device=device, generator=generator),
      gamma=0.99, device=device)
  return OnPolicyTrainLoop(env, agent, metrics.standard_collect_metrics(20),
                           rollout_length=128, device=device)


def phase_reinforce(card):
  import torch

  loop = build_reinforce_loop()
  state = loop.init(0)
  state, losses = loop.run(state, 1)
  state, losses = sync_checked(loop.run, state, REINFORCE_CHECKED)
  finite = bool(torch.isfinite(losses).all())
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  ok = (finite and not off_card
        and state.agent_state.train_step == REINFORCE_CHECKED + 1)
  emit("reinforce", card=card, batch_size=32, rollout_length=128,
       fc=[64, 64], value_baseline=True, sync_debug_mode="error",
       checked_iterations=REINFORCE_CHECKED,
       losses=[float(x) for x in losses], losses_finite=finite,
       tensors_off_card=off_card, train_step=state.agent_state.train_step,
       ok=ok)
  if not ok:
    fail("reinforce", "REINFORCE checks failed")


def numpy_deterministic_actor_params(rng, fc, obs_dim=3, act_dim=1):
  """A flax-shaped deterministic actor tree drawn with numpy."""
  import numpy as np

  def layer(shape, scale):
    return {"kernel": rng.uniform(-scale, scale, shape).astype(np.float32),
            "bias": rng.uniform(-0.05, 0.05, shape[-1:]).astype(np.float32)}

  encoder, width = {}, obs_dim
  for i, out in enumerate(fc):
    encoder[f"Dense_{i}"] = layer((width, out), math.sqrt(3.0 / width))
    width = out
  return {"params": {"EncoderModule_0": encoder,
                     "Dense_0": layer((width, act_dim), 0.3)}}


def phase_td3_parity(card):
  import numpy as np
  import torch

  from agents_tpu_torch.utils import convert
  from examples.td3_pendulum_torch import Config
  from examples.td3_pendulum_torch import build_loop as td3_loop

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  out, ok = {}, True
  cases = (("td3", dict(agent="td3")), ("ddpg", dict(agent="ddpg")),
           ("ddpg_dqda_clipping", dict(agent="ddpg", dqda_clipping=0.5)))
  for i, (name, overrides) in enumerate(cases):
    cfg = Config(**TD3_PARITY, **overrides)
    rng = np.random.RandomState(11 + i)
    actor = numpy_deterministic_actor_params(rng, cfg.actor_fc_layers)
    _, critic1, critic2 = numpy_sac_params(rng, cfg.actor_fc_layers,
                                           cfg.critic_joint_fc_layers)

    def load(loop, actor=actor, critic1=critic1, critic2=critic2):
      agent = loop.agent
      agent.actor_network.load_state_dict(
          convert.deterministic_actor_params_to_state_dict(actor))
      agent.critic_network.load_state_dict(
          convert.sac_critic_params_to_state_dict(critic1))
      if hasattr(agent, "critic_network_2"):
        agent.critic_network_2.load_state_dict(
            convert.sac_critic_params_to_state_dict(critic2))

    runs = run_on_both(
        lambda device, cfg=cfg: td3_loop(dataclasses.replace(cfg,
                                                             device=device)),
        load, initial_collect_steps=TD3_PARITY_INITIAL,
        iterations=TD3_PARITY_ITERATIONS)
    diffs, mismatched = compare_runs(runs, SAC_RTOL, SAC_ATOL, state_tensors)
    gstate = runs["cuda"][1]
    if cfg.agent == "ddpg":
      cpu_ou = runs["cpu"][1].driver_state.policy_state[1][0]
      diffs["ou_state"] = max_diff(cpu_ou, gstate.driver_state.policy_state[
          1][0].cpu())
      if not torch.allclose(cpu_ou, gstate.driver_state.policy_state[1][
          0].cpu(), rtol=SAC_RTOL, atol=SAC_ATOL):
        mismatched.append("ou_state")
    worst = max(diffs, key=diffs.get)
    case_ok = not mismatched and gstate.agent_state.train_step == (
        TD3_PARITY_ITERATIONS * cfg.train_steps_per_iteration)
    ok = ok and case_ok
    out[name] = {"largest_float_diff": {"name": worst, "abs": diffs[worst]},
                 "loss_diff": diffs["losses"], "compared": len(diffs),
                 "mismatched": mismatched, "ok": case_ok}
  emit("td3_parity", card=card, actor=list(TD3_PARITY["actor_fc_layers"]),
       critic=list(TD3_PARITY["critic_joint_fc_layers"]),
       batch_size=TD3_PARITY["env_batch_size"],
       ring=TD3_PARITY["replay_capacity"],
       sample=TD3_PARITY["sample_batch_size"],
       train_steps_per_iteration=TD3_PARITY["train_steps_per_iteration"],
       initial_collect_steps=TD3_PARITY_INITIAL,
       iterations=TD3_PARITY_ITERATIONS, rtol=SAC_RTOL, atol=SAC_ATOL, **out,
       ok=ok)
  if not ok:
    fail("td3_parity", "card and CPU disagree on the TD3/DDPG path")


def phase_td3_main(card):
  import torch

  from examples.td3_pendulum_torch import Config
  from examples.td3_pendulum_torch import build_loop as td3_loop

  cfg = Config()
  loop = td3_loop(cfg)
  state = loop.init(seed=cfg.seed,
                    initial_collect_steps=cfg.initial_collect_steps)
  state, losses = loop.run(state, TD3_WARMUP)
  state, losses = sync_checked(loop.run, state, TD3_CHECKED)
  iterations = TD3_WARMUP + TD3_CHECKED
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  finite = bool(torch.isfinite(losses).all())
  bad_transitions, lasts = check_step_types(loop, state)
  steps = cfg.train_steps_per_iteration
  p = next(state.agent_state.actor_network.parameters())
  actor_adam_steps = float(state.agent_state.actor_optimizer.state[p]["step"])
  ok = (not off_card and finite and bad_transitions == 0
        and state.replay_state.count == cfg.initial_collect_steps + iterations
        and state.agent_state.train_step == iterations * steps
        and actor_adam_steps == iterations * steps // cfg.actor_update_period)
  del loop, state

  # DDPG at the same point: the OU state rides in the driver.
  ddpg = td3_loop(dataclasses.replace(cfg, agent="ddpg"))
  dstate = ddpg.init(seed=cfg.seed,
                     initial_collect_steps=cfg.initial_collect_steps)
  dstate, dlosses = ddpg.run(dstate, 1)
  dstate, dlosses = sync_checked(ddpg.run, dstate, DDPG_CHECKED)
  ou = dstate.driver_state.policy_state[1][0]
  ddpg_ok = (bool(torch.isfinite(dlosses).all()) and ou.device.type == "cuda"
             and bool((ou != 0).any()))
  ok = ok and ddpg_ok
  emit("td3_main", card=card, batch_size=cfg.env_batch_size,
       ring=cfg.replay_capacity, sample_batch_size=cfg.sample_batch_size,
       actor=list(cfg.actor_fc_layers), critic=list(cfg.critic_joint_fc_layers),
       train_steps_per_iteration=steps,
       actor_update_period=cfg.actor_update_period,
       checked_iterations=TD3_CHECKED, sync_debug_mode="error",
       tensors_off_card=off_card,
       losses_finite=finite, last_loss=float(losses[-1]),
       actor_adam_steps=actor_adam_steps,
       illegal_step_type_transitions=bad_transitions,
       last_frames_in_ring=lasts,
       ddpg={"checked_iterations": DDPG_CHECKED, "sync_debug_mode": "error",
             "last_loss": float(dlosses[-1]),
             "ou_state_abs_mean": float(ou.abs().mean()), "ok": ddpg_ok},
       ok=ok)
  if not ok:
    fail("td3_main", "TD3 bench point checks failed")


def phase_td3_learn(card):
  import torch

  from examples.td3_pendulum_torch import parse_td3_args
  from examples.td3_pendulum_torch import build_loop as td3_loop

  cfg = parse_td3_args(["--preset=live"])
  loop = td3_loop(cfg)
  state = loop.init(seed=cfg.seed,
                    initial_collect_steps=cfg.initial_collect_steps)
  iterations, ret, points = 0, -math.inf, []
  while iterations < cfg.num_iterations:
    state, losses = loop.run(state, TD3_LEARN_CHUNK)
    iterations += TD3_LEARN_CHUNK
    ret = float(loop.results(state)["AverageReturn"])
    points.append([iterations, ret])
    if ret >= TD3_LEARN_GATE:
      break
  out = loop.evaluate(state, cfg.seed + 101, num_episodes=30, max_steps=2000)
  episodes = int(out["NumberOfEpisodes"])
  eval_return = float(out["AverageReturn"])
  finite = bool(torch.isfinite(losses).all())
  ok = ret >= TD3_LEARN_GATE and finite and episodes == 30
  emit("td3_learn", card=card, batch_size=cfg.env_batch_size,
       sample_batch_size=cfg.sample_batch_size,
       train_steps_per_iteration=cfg.train_steps_per_iteration,
       actor=list(cfg.actor_fc_layers), critic=list(cfg.critic_joint_fc_layers),
       iterations=iterations, budget=cfg.num_iterations,
       last20_average_return=ret, gate=TD3_LEARN_GATE, points=points,
       losses_finite=finite, eval_episodes=episodes,
       eval_average_return=eval_return, ok=ok)
  if not ok:
    fail("td3_learn", f"last-20 return {ret} (gate {TD3_LEARN_GATE} within "
         f"{cfg.num_iterations} iterations), {episodes} eval episodes of 30")


def numpy_experience(rng, sample_batch_size):
  """A [S, 2] Pendulum-shaped Trajectory batch drawn with numpy, a fifth of
  its actions at the bounds."""
  import numpy as np

  from agents_tpu_torch.trajectories import trajectory as tj

  action = rng.uniform(-2, 2, (sample_batch_size, 2, 1))
  action[rng.uniform(size=action.shape) < 0.2] = 2.0
  return tj.Trajectory(
      step_type=rng.choice([0, 1, 2], (sample_batch_size, 2),
                           p=[0.1, 0.8, 0.1]).astype(np.int32),
      observation=(rng.randn(sample_batch_size, 2, 3) * 2).astype(np.float32),
      action=action.astype(np.float32), policy_info=(),
      next_step_type=rng.choice([1, 2], (sample_batch_size, 2),
                                p=[0.9, 0.1]).astype(np.int32),
      reward=(-rng.uniform(0, 16, (sample_batch_size, 2))).astype(np.float32),
      discount=np.ones((sample_batch_size, 2), np.float32))


def load_agent_state(dst, src):
  """Copy every network, tensor field and optimizer state of the agent
  state `src` into `dst` (in place, onto `dst`'s device; an optimizer's
  state is copied, not shared, even on one device) and return `dst` with
  `src`'s train step."""
  import copy

  import torch

  for field in dataclasses.fields(src):
    value, target = getattr(src, field.name), getattr(dst, field.name)
    if isinstance(value, torch.nn.Module):
      target.load_state_dict(value.state_dict())
    elif isinstance(value, torch.optim.Optimizer):
      target.load_state_dict(copy.deepcopy(value.state_dict()))
    elif isinstance(value, torch.Tensor):
      with torch.no_grad():
        target.copy_(value)
  return dataclasses.replace(dst, train_step=src.train_step)


class BoundedComparison:
  """Card-against-CPU comparisons, each tensor held to max|card - cpu| <=
  atol + rtol * max|cpu| (anything not float: equal)."""

  def __init__(self, rtol, atol):
    self.rtol, self.atol = rtol, atol
    self.diffs, self.relative, self.mismatched = {}, {}, []

  def __call__(self, tag, card_value, cpu_value):
    import torch

    a, b = card_value.detach().cpu(), cpu_value.detach().cpu()
    if not a.dtype.is_floating_point:
      if not torch.equal(a, b):
        self.mismatched.append(tag)
      return
    self.diffs[tag] = max_diff(a, b)
    scale = float(b.double().abs().max()) if b.numel() else 0.0
    self.relative[tag] = self.diffs[tag] / scale if scale else self.diffs[tag]
    if self.diffs[tag] > self.atol + self.rtol * scale:
      self.mismatched.append(tag)

  def nests(self, tag, card_nest, cpu_nest):
    import torch

    from agents_tpu_torch.utils import nest_utils

    for i, (a, b) in enumerate(zip(nest_utils.flatten(card_nest),
                                   nest_utils.flatten(cpu_nest),
                                   strict=True)):
      if isinstance(a, torch.Tensor):
        self(f"{tag}.{i}", a, b)

  def summary(self):
    worst = max(self.diffs, key=self.diffs.get) if self.diffs else None
    worst_rel = max(self.relative, key=self.relative.get) \
        if self.relative else None
    return {"largest_float_diff": {"name": worst,
                                   "abs": self.diffs.get(worst)},
            "largest_relative_diff": {"name": worst_rel,
                                      "of_max_abs": self.relative.get(
                                          worst_rel)},
            "compared": len(self.diffs), "mismatched": self.mismatched}


def to_device(nest, device):
  """Every tensor of a nest (dataclasses included) copied to `device`."""
  import torch

  from agents_tpu_torch.utils import nest_utils

  return nest_utils.tree_map(
      lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, nest)


def new_records(draws, seen):
  """The records of a `RecordingDraws` made since the per-site counts
  `seen`."""
  return {site: v[seen.get(site, 0):] for site, v in draws.records.items()}


def record_counts(draws):
  return {site: len(v) for site, v in draws.records.items()}


def steps_from_cpu_state(agents, draws, batches, compare):
  """A train step per numpy batch by the "host" agent (drawing from the
  `RecordingDraws` `draws`), each repeated by the "card" agent from the
  host's state before it with the host's draws replayed; the losses, the
  extras and every tensor of the state compared after each. Returns (host
  state, card state, the card's loss infos)."""
  import torch

  from agents_tpu_torch.utils import nest_utils
  from agents_tpu_torch.utils.draws import ReplayDraws

  cstate = agents["host"].init(draws=draws)
  gstate = agents["card"].init()
  infos = []
  for step, batch in enumerate(batches, start=1):
    gstate = load_agent_state(gstate, cstate)
    seen = record_counts(draws)
    cstate, cinfo = agents["host"].train(
        cstate, nest_utils.tree_map(torch.from_numpy, batch))
    gstate = dataclasses.replace(gstate, draws=ReplayDraws(
        new_records(draws, seen), "cuda"))
    gstate, ginfo = agents["card"].train(gstate, nest_utils.tree_map(
        lambda x: torch.from_numpy(x).to("cuda"), batch))
    compare(f"step{step}.loss", ginfo.loss, cinfo.loss)
    for field in dataclasses.fields(cinfo.extra):
      compare(f"step{step}.extra.{field.name}",
              getattr(ginfo.extra, field.name),
              getattr(cinfo.extra, field.name))
    ctensors, gtensors = state_tensors(cstate), state_tensors(gstate)
    if set(ctensors) != set(gtensors):
      compare.mismatched.append(f"step{step}.agent_state.names")
    for k in ctensors:
      compare(f"step{step}.{k}", gtensors[k], ctensors[k])
    infos.append(ginfo)
  return cstate, gstate, infos


def phase_cql_parity(card):
  """Three CQL-SAC steps, each taken by the card from the CPU's state
  before it.

  The first step from one set of numpy-made parameters agrees to about
  1e-6 of each tensor's scale. Run on from there, the card's own states
  part at a few elements: Adam normalises each gradient by its running
  size, so an element whose gradient is near zero moves by up to the
  learning rate either way on rounding alone, and with 5,376 critic rows
  a pre-activation a rounding away from a ReLU kink changes side. So
  before each step the card takes the CPU's state (networks, log alphas,
  the four Adams), replays the CPU's draws, and each step is held to
  max|card - cpu| <= 1e-5 + 1e-4 max|cpu| per tensor.
  """
  import numpy as np
  import torch

  from agents_tpu_torch.utils import convert
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws
  from examples.cql_sac_offline_torch import KUMAR20, Config, build_agent
  from examples.cql_sac_offline_torch import build_env

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cases = (("offline_default", Config(num_bc_steps=1), {}),
           ("kumar20_lagrange", Config(**{**KUMAR20, "num_bc_steps": 1}),
            dict(use_lagrange_cql_alpha=True, cql_tau=5.0,
                 log_cql_alpha_clipping=(-2.0, 2.0))))
  out, ok = {}, True
  for i, (name, cfg, extra) in enumerate(cases):
    rng = np.random.RandomState(21 + i)
    actor, critic1, critic2 = numpy_sac_params(
        rng, cfg.actor_fc_layers, cfg.critic_joint_fc_layers)
    batches = [numpy_experience(rng, CQL_PARITY_SAMPLE)
               for _ in range(CQL_PARITY_STEPS)]
    agents = {}
    for role, device in (("host", "cpu"), ("card", "cuda")):
      cfg_d = dataclasses.replace(cfg, device=device)
      agent = build_agent(cfg_d, build_env(cfg_d), "cql", cfg.seed + 2)
      for key, value in extra.items():
        setattr(agent, key, value)
      agent.actor_network.load_state_dict(
          convert.sac_actor_params_to_state_dict(actor))
      agent.critic_network.load_state_dict(
          convert.sac_critic_params_to_state_dict(critic1))
      agent.critic_network_2.load_state_dict(
          convert.sac_critic_params_to_state_dict(critic2))
      agents[role] = agent
    compare = BoundedComparison(CQL_RTOL, CQL_ATOL)
    _, gstate, infos = steps_from_cpu_state(
        agents, RecordingDraws(Draws(0, "cpu")), batches, compare)
    case_ok = not compare.mismatched and gstate.train_step == CQL_PARITY_STEPS
    ok = ok and case_ok
    out[name] = {
        "actor": list(cfg.actor_fc_layers),
        "critic": list(cfg.critic_joint_fc_layers),
        "num_cql_samples": cfg.num_cql_samples,
        "softmax_temperature": cfg.softmax_temperature,
        "lagrange": bool(extra), "num_bc_steps": 1, **compare.summary(),
        "cql_loss_diff": max(v for k, v in compare.diffs.items()
                             if k.endswith("extra.cql_loss")),
        "cql_loss": [float(i.extra.cql_loss) for i in infos], "ok": case_ok}
  emit("cql_parity", card=card, steps=CQL_PARITY_STEPS,
       sample=CQL_PARITY_SAMPLE, rtol=CQL_RTOL, atol=CQL_ATOL,
       criterion="each step from the CPU's state before it: max|card - cpu| "
       "<= atol + rtol * max|cpu| per tensor", **out, ok=ok)
  if not ok:
    fail("cql_parity", "card and CPU disagree on the CQL-SAC step")


def phase_cql_main(card):
  import torch

  from agents_tpu_torch.drivers import TorchDriver
  from agents_tpu_torch.policies import RandomPolicy
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils.draws import Draws
  from examples.cql_sac_offline_torch import KUMAR20, Config, build_agent
  from examples.cql_sac_offline_torch import build_env

  cfg = Config(**{**KUMAR20, "env_batch_size": CQL_RING_ROWS})
  env = build_env(cfg)
  tss, asp = env.time_step_spec(), env.action_spec()
  replay = UniformReplay(tj.trajectory_spec(tss, asp), CQL_RING_ROWS,
                         CQL_RING_FRAMES, device=env.device)
  driver = TorchDriver(env, RandomPolicy(tss, asp),
                       observers=[replay.add_batch])
  draws = Draws(cfg.seed, env.device)
  _, (rstate,) = driver.run((), driver.init(draws), (replay.init(),), draws,
                            CQL_RING_FRAMES)
  agent = build_agent(cfg, env, "cql", cfg.seed + 2)

  def train_steps(state, steps):
    for _ in range(steps):
      experience, _ = replay.sample(rstate, draws, cfg.offline_batch_size,
                                    num_steps=2)
      state, info = agent.train(state, experience)
    return state, info.loss

  state, _ = sync_checked(train_steps, agent.init(), CQL_CHECKED)
  state = dataclasses.replace(state, train_step=cfg.num_bc_steps)
  state, loss = sync_checked(train_steps, state, CQL_CHECKED)
  off_card = [k for k, v in state_tensors(state).items()
              if k != "train_step" and not k.endswith(".step")
              and v.device.type != "cuda"]
  finite = bool(torch.isfinite(loss)) and bool(torch.isfinite(
      state.log_alpha.detach()))
  ok = (finite and not off_card and rstate.count == CQL_RING_FRAMES
        and state.train_step == cfg.num_bc_steps + CQL_CHECKED)
  emit("cql_main", card=card, ring_rows=CQL_RING_ROWS,
       ring_frames=CQL_RING_FRAMES,
       sample_batch_size=cfg.offline_batch_size,
       actor=list(cfg.actor_fc_layers), critic=list(cfg.critic_joint_fc_layers),
       num_cql_samples=cfg.num_cql_samples,
       critic_rows_per_pass=(2 * cfg.num_cql_samples + 1)
       * cfg.offline_batch_size,
       sync_debug_mode="error", checked_steps_per_phase=CQL_CHECKED,
       last_loss=float(loss), losses_finite=finite,
       tensors_off_card=off_card, train_step=state.train_step, ok=ok)
  if not ok:
    fail("cql_main", "kumar20 CQL train step checks failed")


def phase_cql_offline(card, data_dir):
  """The offline example's pipeline; returns (config, env, behaviour agent,
  its state) for `bc`."""
  import torch

  from examples.cql_sac_offline_torch import (Config, behavior_phase,
                                              build_env, dataset_phase,
                                              greedy_eval, offline_phase)

  cfg = Config()
  env = build_env(cfg)
  behavior, behavior_state, iterations, collect_return = behavior_phase(
      cfg, env)
  behavior_return, _ = greedy_eval(cfg, env, behavior, behavior_state,
                                   cfg.num_eval_episodes, cfg.seed + 7)
  dataset_return = dataset_phase(cfg, env, behavior, behavior_state, data_dir)
  bc_phase = {}

  def on_step(step, agent, agent_state):
    if step == cfg.num_bc_steps:
      bc_phase["return"], bc_phase["episodes"] = greedy_eval(
          cfg, env, agent, agent_state, cfg.num_eval_episodes, cfg.seed + 7)

  agent, agent_state, losses, rstate = offline_phase(cfg, env, data_dir,
                                                     on_step=on_step)
  offline_return, episodes = greedy_eval(cfg, env, agent, agent_state,
                                         cfg.num_eval_episodes, cfg.seed + 7)
  finite = bool(torch.isfinite(losses).all())
  ok = (behavior_return > CQL_BEHAVIOR_GATE and bc_phase["return"]
        > CQL_BC_GATE and offline_return > CQL_OFFLINE_GATE and finite
        and rstate.count == cfg.dataset_frames
        and episodes == bc_phase["episodes"] == cfg.num_eval_episodes)
  emit("cql_offline", card=card, batch_size=cfg.env_batch_size,
       behavior_iterations=iterations, behavior_last20_return=collect_return,
       behavior_greedy_return=behavior_return,
       behavior_gate=CQL_BEHAVIOR_GATE,
       dataset_frames=rstate.count, dataset_rows=cfg.env_batch_size,
       dataset_policy_return=dataset_return,
       offline_train_steps=cfg.offline_train_steps,
       num_bc_steps=cfg.num_bc_steps, bc_phase_return=bc_phase["return"],
       bc_gate=CQL_BC_GATE, offline_return=offline_return,
       offline_gate=CQL_OFFLINE_GATE, eval_episodes=episodes,
       last_loss=float(losses[-1]), losses_finite=finite, ok=ok)
  if not ok:
    fail("cql_offline", f"behaviour {behavior_return}, after BC "
         f"{bc_phase['return']}, offline {offline_return}")
  return cfg, env, behavior, behavior_state


def phase_bc(card, cfg, env, data_dir, behavior, behavior_state):
  """Behavioural cloning on the offline phase's dataset, scored against
  that dataset's behaviour policy: a fixed return bar would not carry
  from one behaviour run to another."""
  import torch

  from agents_tpu_torch.agents.random import RandomAgent
  from examples.cql_sac_offline_torch import greedy_eval, offline_phase

  agent, agent_state, losses, _ = offline_phase(cfg, env, data_dir,
                                                kind="bc")
  ret, episodes = greedy_eval(cfg, env, agent, agent_state, 30, cfg.seed + 7)
  behavior_return, _ = greedy_eval(cfg, env, behavior, behavior_state, 30,
                                   cfg.seed + 7)
  random = RandomAgent(env.time_step_spec(), env.action_spec(), env.device)
  random_return, _ = greedy_eval(cfg, env, random, random.init(), 30,
                                 cfg.seed + 7)
  score = (ret - random_return) / (behavior_return - random_return)
  finite = bool(torch.isfinite(losses).all())
  ok = score >= BC_SCORE_GATE and finite and episodes == 30
  emit("bc", card=card, train_steps=cfg.offline_train_steps,
       sample_batch_size=cfg.offline_batch_size,
       actor=list(cfg.actor_fc_layers), eval_episodes=episodes,
       eval_average_return=ret, behavior_greedy_return=behavior_return,
       random_policy_return=random_return, normalized_score=score,
       gate=BC_SCORE_GATE, last_loss=float(losses[-1]),
       losses_finite=finite, ok=ok)
  if not ok:
    fail("bc", f"BC normalized score {score} (return {ret}, behaviour "
         f"{behavior_return}, random {random_return}; gate "
         f"{BC_SCORE_GATE}), {episodes} eval episodes of 30")


def phase_offline(card):
  """`cql_offline`, then `bc` on its dataset."""
  os.makedirs(RUNS_DIR, exist_ok=True)
  with tempfile.TemporaryDirectory(dir=RUNS_DIR) as data_dir:
    cfg, env, behavior, behavior_state = phase_cql_offline(card, data_dir)
    phase_bc(card, cfg, env, data_dir, behavior, behavior_state)


def numpy_qtopt_critic(rng, fc, obs_dim=3, act_dim=1):
  """A flax-shaped critic tree drawn with numpy whose Q layer is as wide as
  the others, so Q varies with the action on the scale of its inputs."""
  import numpy as np

  _, critic, _ = numpy_sac_params(rng, fc, fc, obs_dim, act_dim)
  last = critic["params"][f"Dense_{len(fc)}"]
  scale = math.sqrt(3.0 / fc[-1])
  last["kernel"] = rng.uniform(-scale, scale, last["kernel"].shape).astype(
      np.float32)
  return critic


def cem_trace(policy, params, time_step, draws):
  """`CEMPolicy.optimize`'s refit loop step by step: per iteration, each
  row's elite indices (sorted) and whether the gap between its E-th and
  (E+1)-th Q exceeds QTOPT_GAP of the largest |Q|, so rounding cannot
  swap an elite there."""
  import torch

  sampler, e = policy.sampler, policy.num_elites
  b = time_step.step_type.shape[0]
  dist = sampler.init(b, policy.initial_std, device=time_step.step_type.device)
  out = []
  for _ in range(policy.num_iterations):
    samples = sampler.sample_batch_and_clip(draws, policy.num_samples, dist)
    q = policy._eval_q(params, time_step, samples)
    top = torch.topk(q.T, e + 1, dim=-1)
    gap = top.values[:, e - 1] - top.values[:, e]
    out.append((torch.sort(top.indices[:, :e], dim=-1).values.cpu(),
                (gap > QTOPT_GAP * q.abs().max()).cpu()))
    dist = sampler.refit_distribution_to(top.indices[:, :e], samples)
  return out


def compare_cem(policy, cpu_params, card_params, cpu_step, records, tag,
                compare):
  """Trace CEM on both devices from one record of draws: equal elites on
  every row whose gaps are clear on both, and the actions and Q values
  `optimize` returns on the rows clear at every iteration. Returns the
  rows compared at each iteration and the rows clear at every one."""
  import torch

  from agents_tpu_torch.utils.draws import ReplayDraws

  card_step = to_device(cpu_step, "cuda")
  ctrace = cem_trace(policy, cpu_params, cpu_step,
                     ReplayDraws(records, "cpu"))
  gtrace = cem_trace(policy, card_params, card_step,
                     ReplayDraws(records, "cuda"))
  clear, per_iteration = torch.ones_like(ctrace[0][1]), []
  for i, ((celite, cclear), (gelite, gclear)) in enumerate(zip(ctrace,
                                                              gtrace)):
    both = cclear & gclear
    if not torch.equal(celite[both], gelite[both]):
      compare.mismatched.append(f"{tag}.elites.{i}")
    clear = clear & both
    per_iteration.append(int(both.sum()))
  caction, cq = policy.optimize(cpu_params, cpu_step,
                                ReplayDraws(records, "cpu"))
  gaction, gq = policy.optimize(card_params, card_step,
                                ReplayDraws(records, "cuda"))
  compare(f"{tag}.action", gaction.cpu()[clear], caction[clear])
  compare(f"{tag}.q", gq.cpu()[clear], cq[clear])
  return per_iteration, int(clear.sum())


def cem_settings(policy):
  """A `CEMPolicy`'s samples, elites and iterations, for a phase's line."""
  return {"samples": policy.num_samples, "elites": policy.num_elites,
          "iterations": policy.num_iterations}


def qtopt_agents(cfg):
  """The example's QtOpt agent of `cfg` on "cpu" ("host") and on "cuda"
  ("card"), their critics loaded from one numpy-made tree."""
  import numpy as np
  import torch

  from agents_tpu_torch.environments.classic import Pendulum
  from agents_tpu_torch.utils import convert
  from examples.td3_pendulum_torch import build_agent

  critic = convert.sac_critic_params_to_state_dict(numpy_qtopt_critic(
      np.random.RandomState(31), cfg.critic_joint_fc_layers))
  env, agents = Pendulum(cfg.max_episode_steps), {}
  for role, device in (("host", "cpu"), ("card", "cuda")):
    generator = torch.Generator(device=device).manual_seed(0)
    agent = build_agent(dataclasses.replace(cfg, device=device),
                        env.time_step_spec(), env.action_spec(), device,
                        generator)
    agent.q_network.load_state_dict(critic)
    agents[role] = agent
  return agents


def phase_qtopt_parity(card):
  """QtOpt card against CPU, TF32 off: (a) `CEMPolicy.optimize` over the
  bench critic at B=256, (b) 3 train steps at sample 256, each from the
  CPU's state before it, (c) the epsilon-greedy-over-CEM collect policy's
  actions. The card replays the CPU's draws. CEM's elite choice is
  discontinuous: where two Q values lie within rounding a GEMM's summation
  order may swap an elite, so elites are held on the rows whose gap is
  clear, and actions on the rows clear at every iteration."""
  import numpy as np
  import torch

  from agents_tpu_torch.trajectories import time_step as ts
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws
  from examples.td3_pendulum_torch import Config

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cfg = Config(agent="qtopt")
  agents = qtopt_agents(cfg)
  compare = BoundedComparison(QTOPT_RTOL, QTOPT_ATOL)
  rng = np.random.RandomState(32)

  # (a) CEM alone, over the critic.
  obs = torch.from_numpy((rng.randn(QTOPT_PARITY_B, 3) * 2).astype(
      np.float32))
  cpu_step = ts.restart(obs, QTOPT_PARITY_B)
  policy = agents["host"].policy
  rec = RecordingDraws(Draws(0, "cpu"))
  policy.optimize(agents["host"].q_network, cpu_step, rec)
  cem_rows, cem_clear_rows = compare_cem(policy, agents["host"].q_network,
                         agents["card"].q_network, cpu_step, rec.records,
                         "cem", compare)

  # (b) train steps, each from the CPU's state.
  batches = [numpy_experience(rng, QTOPT_PARITY_SAMPLE)
             for _ in range(QTOPT_PARITY_STEPS)]
  cstate, gstate, infos = steps_from_cpu_state(
      agents, RecordingDraws(Draws(0, "cpu")), batches, compare)
  losses = [float(i.loss) for i in infos]

  # (c) the collect policy on the CPU's time steps.
  collect = BoundedComparison(QTOPT_RTOL, QTOPT_ATOL)
  gstate = load_agent_state(gstate, cstate)
  obs = torch.from_numpy((rng.randn(QTOPT_PARITY_B, 3) * 2).astype(
      np.float32))
  cpu_step = ts.restart(obs, QTOPT_PARITY_B)
  rec = RecordingDraws(Draws(1, "cpu"))
  agent = agents["host"]
  caction = agent.collect_policy.action(agent.collect_policy_params(cstate),
                                        cpu_step, (), rec).action
  gaction = agents["card"].collect_policy.action(
      agents["card"].collect_policy_params(gstate),
      to_device(cpu_step, "cuda"), (), ReplayDraws(rec.records, "cuda")).action
  explore = torch.from_numpy(
      rec.records["explore"][0] < agent.collect_policy.epsilon)
  trace = cem_trace(agent.policy, agent.collect_policy_params(cstate),
                    cpu_step, ReplayDraws({"cem_normal": rec.records[
                        "cem_normal"]}, "cpu"))
  clear = torch.stack([c for _, c in trace]).all(0)
  collect("collect.explored", gaction.cpu()[explore], caction[explore])
  collect("collect.greedy", gaction.cpu()[clear & ~explore],
          caction[clear & ~explore])
  ok = (not compare.mismatched and not collect.mismatched
        and gstate.train_step == QTOPT_PARITY_STEPS
        and bool((caction.abs() <= 2.0).all()))
  emit("qtopt_parity", card=card, critic=list(cfg.critic_joint_fc_layers),
       cem=cem_settings(policy),
       batch_size=QTOPT_PARITY_B, train_steps=QTOPT_PARITY_STEPS,
       sample=QTOPT_PARITY_SAMPLE, rtol=QTOPT_RTOL, atol=QTOPT_ATOL,
       elite_gap=QTOPT_GAP,
       criterion="each train step from the CPU's state; max|card - cpu| <= "
       "atol + rtol * max|cpu| per tensor; elites where the E-th/(E+1)-th "
       "gap exceeds elite_gap * max|Q|",
       cem_elite_rows_compared=cem_rows,
       cem_rows_clear_every_iteration=cem_clear_rows, losses=losses,
       **compare.summary(),
       collect={"explored_rows": int(explore.sum()),
                "greedy_rows_compared": int((clear & ~explore).sum()),
                **collect.summary()}, ok=ok)
  if not ok:
    fail("qtopt_parity", "card and CPU disagree on the QtOpt path")


def phase_qtopt_main(card):
  import torch

  from examples.td3_pendulum_torch import Config
  from examples.td3_pendulum_torch import build_loop as td3_loop

  cfg = Config(agent="qtopt")
  loop = td3_loop(cfg)
  state = loop.init(seed=cfg.seed,
                    initial_collect_steps=cfg.initial_collect_steps)
  state, losses = loop.run(state, QTOPT_WARMUP)
  state, losses = sync_checked(loop.run, state, QTOPT_CHECKED)
  iterations = QTOPT_WARMUP + QTOPT_CHECKED
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  finite = bool(torch.isfinite(losses).all())
  bad_transitions, lasts = check_step_types(loop, state)
  steps = cfg.train_steps_per_iteration
  ok = (not off_card and finite and bad_transitions == 0
        and state.replay_state.count == cfg.initial_collect_steps + iterations
        and state.agent_state.train_step == iterations * steps)
  emit("qtopt_main", card=card, batch_size=cfg.env_batch_size,
       ring=cfg.replay_capacity, sample_batch_size=cfg.sample_batch_size,
       critic=list(cfg.critic_joint_fc_layers),
       cem=cem_settings(loop.agent.policy),
       train_steps_per_iteration=steps, checked_iterations=QTOPT_CHECKED,
       sync_debug_mode="error", tensors_off_card=off_card,
       losses_finite=finite, last_loss=float(losses[-1]),
       illegal_step_type_transitions=bad_transitions,
       last_frames_in_ring=lasts, ok=ok)
  if not ok:
    fail("qtopt_main", "QtOpt bench point checks failed")


def phase_qtopt_learn(card):
  import torch

  from examples.td3_pendulum_torch import build_loop as td3_loop
  from examples.td3_pendulum_torch import parse_td3_args

  cfg = parse_td3_args(["--preset=live", "--agent=qtopt"])
  loop = td3_loop(cfg)
  state = loop.init(seed=cfg.seed,
                    initial_collect_steps=cfg.initial_collect_steps)
  iterations, ret, points = 0, -math.inf, []
  while iterations < cfg.num_iterations:
    state, losses = loop.run(state, QTOPT_LEARN_CHUNK)
    iterations += QTOPT_LEARN_CHUNK
    ret = float(loop.results(state)["AverageReturn"])
    points.append([iterations, ret])
    if ret >= QTOPT_LEARN_GATE:
      break
  out = loop.evaluate(state, cfg.seed + 101, num_episodes=30, max_steps=2000)
  episodes = int(out["NumberOfEpisodes"])
  eval_return = float(out["AverageReturn"])
  finite = bool(torch.isfinite(losses).all())
  ok = ret >= QTOPT_LEARN_GATE and finite and episodes == 30
  emit("qtopt_learn", card=card, batch_size=cfg.env_batch_size,
       sample_batch_size=cfg.sample_batch_size,
       train_steps_per_iteration=cfg.train_steps_per_iteration,
       critic=list(cfg.critic_joint_fc_layers), iterations=iterations,
       budget=cfg.num_iterations, last20_average_return=ret,
       gate=QTOPT_LEARN_GATE, points=points, losses_finite=finite,
       eval_episodes=episodes, eval_average_return=eval_return, ok=ok)
  if not ok:
    fail("qtopt_learn", f"last-20 return {ret} (gate {QTOPT_LEARN_GATE} "
         f"within {cfg.num_iterations} iterations), {episodes} eval "
         "episodes of 30")


def _discrete_envs():
  from agents_tpu_torch.environments.classic import (Acrobot,
                                                     ContinuousMountainCar,
                                                     MountainCar)

  return (("acrobot", lambda: Acrobot(30)),
          ("mountain_car", lambda: MountainCar(40)),
          ("continuous_mountain_car", lambda: ContinuousMountainCar(40)))


def discrete_env_parity(compare):
  """Each env for DISCRETE_ENV_STEPS steps of random actions (and
  auto-resets), the card taking the CPU's state and time step before each
  step and replaying its reset draws. Returns the LAST frames seen per
  env."""
  import numpy as np
  import torch

  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws

  lasts = {}
  for i, (name, make) in enumerate(_discrete_envs()):
    cenv = BatchedTorchEnv(make(), DISCRETE_B, device="cpu")
    genv = BatchedTorchEnv(make(), DISCRETE_B, device="cuda")
    spec = cenv.action_spec()
    rng = np.random.RandomState(40 + i)
    draws = RecordingDraws(Draws(40 + i, "cpu"))
    cstate, cstep = cenv.reset(draws)
    lasts[name] = 0
    for t in range(DISCRETE_ENV_STEPS):
      if np.issubdtype(spec.dtype, np.integer):
        action = torch.from_numpy(rng.randint(0, 3, DISCRETE_B).astype(
            np.int32))
      else:
        action = torch.from_numpy(rng.uniform(
            -1.5, 1.5, (DISCRETE_B,) + spec.shape).astype(np.float32))
      seen = record_counts(draws)
      nstate, nstep = cenv.step(cstate, cstep, action, draws)
      gstate, gstep = genv.step(
          to_device(cstate, "cuda"), to_device(cstep, "cuda"),
          action.to("cuda"), ReplayDraws(new_records(draws, seen), "cuda"))
      compare.nests(f"{name}.state", gstate, nstate)
      compare.nests(f"{name}.time_step", gstep, nstep)
      cstate, cstep = nstate, nstep
      lasts[name] += int(cstep.is_last().sum())
  return lasts


def boltzmann_dqn_loop(device):
  """Boltzmann-collect DQN on Acrobot (30-step episodes), B=16, ring 64,
  sample 32, 2 train steps per iteration, (64, 64), temperature 0.5."""
  import torch

  from agents_tpu_torch import metrics
  from agents_tpu_torch.agents.dqn import DqnAgent
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import Acrobot
  from agents_tpu_torch.networks import make_q_network
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.train import FusedTrainLoop
  from agents_tpu_torch.trajectories import trajectory as tj

  env = BatchedTorchEnv(Acrobot(30), 16, device=device)
  tss, asp = env.time_step_spec(), env.action_spec()
  generator = torch.Generator(device=device).manual_seed(0)
  agent = DqnAgent(tss, asp, make_q_network(
      tss.observation, asp, fc_layer_params=(64, 64), device=device,
      generator=generator), lambda p: torch.optim.Adam(p, lr=1e-3),
                   boltzmann_temperature=0.5, gamma=0.99,
                   target_update_tau=0.05, device=device)
  replay = UniformReplay(tj.trajectory_spec(tss, asp), 16, 64, device=device)
  return FusedTrainLoop(env, agent, replay,
                        metrics=metrics.standard_collect_metrics(5),
                        sample_batch_size=32, train_steps_per_iteration=2,
                        device=device)


def discrete_dqn_parity(compare):
  """DISCRETE_DQN_ITERATIONS fused iterations of `boltzmann_dqn_loop`, the
  card taking the CPU's whole loop state (driver, replay, metrics, agent)
  before each and replaying that iteration's draws."""
  import numpy as np

  from agents_tpu_torch.replay_buffers.uniform_replay import ReplayState
  from agents_tpu_torch.utils import convert
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws

  loops = {"host": boltzmann_dqn_loop("cpu"),
           "card": boltzmann_dqn_loop("cuda")}
  weights = convert.q_params_to_state_dict(numpy_q_params(
      np.random.RandomState(41), (64, 64), obs_dim=6, num_actions=3))
  for loop in loops.values():
    loop.agent.q_network.load_state_dict(weights)
  draws = RecordingDraws(Draws(41, "cpu"))
  cstate = loops["host"].init(draws=draws, initial_collect_steps=16)
  gstate = loops["card"].init(draws=Draws(0, "cuda"))
  losses = []
  for it in range(DISCRETE_DQN_ITERATIONS):
    gstate = dataclasses.replace(
        gstate, driver_state=to_device(cstate.driver_state, "cuda"),
        replay_state=ReplayState(to_device(cstate.replay_state.storage,
                                           "cuda"),
                                 cstate.replay_state.count),
        metric_states=to_device(cstate.metric_states, "cuda"),
        agent_state=load_agent_state(gstate.agent_state, cstate.agent_state))
    seen = record_counts(draws)
    cstate, closs = loops["host"].iteration(cstate)
    gstate = dataclasses.replace(gstate, draws=ReplayDraws(
        new_records(draws, seen), "cuda"))
    gstate, gloss = loops["card"].iteration(gstate)
    compare(f"dqn.iteration{it}.loss", gloss.loss, closs.loss)
    ctensors, gtensors = (state_tensors(cstate.agent_state),
                          state_tensors(gstate.agent_state))
    for k in ctensors:
      compare(f"dqn.iteration{it}.{k}", gtensors[k], ctensors[k])
    compare.nests(f"dqn.iteration{it}.replay", gstate.replay_state.storage,
                  cstate.replay_state.storage)
    compare.nests(f"dqn.iteration{it}.time_step",
                  gstate.driver_state.time_step, cstate.driver_state.time_step)
    losses.append(float(gloss.loss))
  return losses, cstate.replay_state.storage.action


def discrete_policy_parity(compare):
  """A masked `QPolicy` (a splitter over a [B, 6 + 3] observation), a
  shifted one (actions 1-3), and epsilon-greedy at 0.5 over each: the card
  against the CPU on one batch, greedy actions on the rows whose top-two
  valid Q values are clear of rounding, exploring actions on every
  exploring row; exploration stays inside the mask and the shift."""
  import numpy as np
  import torch

  from agents_tpu_torch import distributions as dist_lib
  from agents_tpu_torch.networks import make_q_network
  from agents_tpu_torch.policies import EpsilonGreedyPolicy, GreedyPolicy
  from agents_tpu_torch.policies import QPolicy
  from agents_tpu_torch.specs import array_spec
  from agents_tpu_torch.trajectories import time_step as ts
  from agents_tpu_torch.utils import convert
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws

  rng = np.random.RandomState(42)
  b = QTOPT_PARITY_B
  mask = rng.rand(b, 3) < 0.5
  mask[np.arange(b), rng.randint(0, 3, b)] = True
  obs = np.concatenate([rng.randn(b, 6), mask], -1).astype(np.float32)
  weights = convert.q_params_to_state_dict(numpy_q_params(
      rng, (64, 64), obs_dim=6, num_actions=3))
  split = lambda o: (o[..., :6], o[..., 6:] > 0.5)  # noqa: E731
  out = {}
  for name, minimum, splitter in (("masked", 0, split),
                                  ("shifted", 1, None)):
    spec = array_spec.BoundedArraySpec((), np.int32, minimum, minimum + 2)
    obs_spec = array_spec.ArraySpec((9 if splitter else 6,), np.float32)
    x = obs if splitter else obs[:, :6]
    policies, nets = {}, {}
    for role, device in (("host", "cpu"), ("card", "cuda")):
      nets[role] = make_q_network(array_spec.ArraySpec((6,), np.float32),
                                  spec, fc_layer_params=(64, 64),
                                  device=device)
      nets[role].load_state_dict(weights)
      policies[role] = QPolicy(ts.time_step_spec(obs_spec), spec, nets[role],
                               splitter)
    cstep = ts.restart(torch.from_numpy(x), b)
    gstep = to_device(cstep, "cuda")
    with torch.no_grad():
      q_raw = policies["host"].distribution(nets["host"], cstep).action.logits
    valid = torch.from_numpy(mask) if splitter else torch.ones_like(
        q_raw, dtype=torch.bool)
    # The scale of rounding is that of the valid Q values alone; a single
    # valid action has no runner-up and is clear by itself.
    q = torch.where(valid, q_raw, dist_lib.NEG_INF)
    top = torch.topk(q, 2, dim=-1).values
    clear = (top[:, 0] - top[:, 1]) > QTOPT_GAP * q_raw[valid].abs().max()
    contested = clear & (valid.sum(-1) >= 2)
    if not bool(contested.any()):
      compare.mismatched.append(f"{name}.no_contested_rows")
    cgreedy = GreedyPolicy(policies["host"]).action(nets["host"], cstep).action
    ggreedy = GreedyPolicy(policies["card"]).action(nets["card"],
                                                    gstep).action
    compare(f"{name}.greedy", ggreedy.cpu()[clear], cgreedy[clear])
    rec = RecordingDraws(Draws(43, "cpu"))
    caction = EpsilonGreedyPolicy(policies["host"], 0.5).action(
        nets["host"], cstep, (), rec).action
    gaction = EpsilonGreedyPolicy(policies["card"], 0.5).action(
        nets["card"], gstep, (), ReplayDraws(rec.records, "cuda")).action
    explore = torch.from_numpy(rec.records["explore"][0] < 0.5)
    compare(f"{name}.explored", gaction.cpu()[explore], caction[explore])
    compare(f"{name}.epsilon_greedy", gaction.cpu()[clear], caction[clear])
    inside = bool(((caction >= minimum) & (caction <= minimum + 2)).all())
    if splitter:
      inside = inside and bool(mask[np.arange(b), caction.numpy()].all())
    if not inside:
      compare.mismatched.append(f"{name}.outside")
    out[name] = {"greedy_rows_compared": int(clear.sum()),
                 "greedy_rows_with_two_or_more_valid": int(contested.sum()),
                 "explored_rows": int(explore.sum()),
                 "actions_seen": sorted(set(caction.tolist()))}
  return out


def phase_discrete_parity(card):
  """The discrete-action surface, card against CPU, TF32 off."""
  import torch

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  compare = BoundedComparison(QTOPT_RTOL, QTOPT_ATOL)
  lasts = discrete_env_parity(compare)
  losses, actions = discrete_dqn_parity(compare)
  policies = discrete_policy_parity(compare)
  ok = (not compare.mismatched and all(v > 0 for v in lasts.values())
        and len(set(actions.flatten().tolist())) == 3
        and all(math.isfinite(v) for v in losses))
  emit("discrete_parity", card=card, batch_size=DISCRETE_B,
       env_steps=DISCRETE_ENV_STEPS, last_frames=lasts,
       dqn={"iterations": DISCRETE_DQN_ITERATIONS, "losses": losses,
            "boltzmann_temperature": 0.5},
       policies=policies, rtol=QTOPT_RTOL, atol=QTOPT_ATOL,
       criterion="each env step and DQN iteration from the CPU's state; "
       "max|card - cpu| <= atol + rtol * max|cpu| per tensor; integers "
       "and step types equal", **compare.summary(), ok=ok)
  if not ok:
    fail("discrete_parity", "card and CPU disagree on the discrete surface")


# -- recurrent networks and checkpoint-resume (the seventh slice) ---------------

RNN_PARITY_B, RNN_PARITY_T = 64, 16
RNN_DQN_PARITY_STEPS, RNN_DQN_PARITY_SAMPLE, RNN_SEQUENCE = 3, 256, 10
RNN_RTOL, RNN_ATOL, RNN_ARGMAX_GAP = 1e-4, 1e-5, 1e-5
# `rnn_dqn_main`'s sync-checked stretch: two periods of the target update
# (every 5); its profile one.
RNN_DQN_WARMUP, RNN_DQN_CHECKED, RNN_DQN_PROFILED = 5, 10, 5
PPO_RNN_WARMUP, PPO_RNN_CHECKED = 1, 1
# The JAX package's runs at this config reach 185.6, 157.5, 179.4, 160.5
# and 108.65 over seeds 0-4 (`tests/test_torch_reference_bars.py ppo_rnn`):
# all five clear the JAX test's 35, so the bar is `ppo_rnn_bar`'s, the worst
# less a third of the spread.
PPO_RNN_LEARN_CHUNK, PPO_RNN_LEARN_GATE = 5, 83.0
CKPT_DQN_ITERATIONS, CKPT_PPO_ITERATIONS, CKPT_SAC_ITERATIONS = 50, 3, 3


def numpy_lstm_encoder(rng, obs_dim, input_fc=(40,), lstm=40,
                       output_fc=(40,)):
  """A flax-shaped `LSTMEncoderModule_0` subtree drawn with numpy, and its
  output width."""
  import numpy as np

  def uniform(shape, scale):
    return rng.uniform(-scale, scale, shape).astype(np.float32)

  def dense(width, out):
    return {"kernel": uniform((width, out), math.sqrt(3.0 / width)),
            "bias": uniform((out,), 0.05)}

  encoder, width, i = {}, obs_dim, 0
  for out in input_fc:
    encoder[f"Dense_{i}"], width, i = dense(width, out), out, i + 1
  cell = {}
  for gate in "ifgo":
    cell[f"i{gate}"] = {"kernel": uniform((width, lstm),
                                          math.sqrt(3.0 / width))}
    cell[f"h{gate}"] = {"kernel": uniform((lstm, lstm), math.sqrt(3.0 / lstm)),
                        "bias": uniform((lstm,), 0.1)}
  encoder["Scan_MaskedLSTMCell_0"] = {"OptimizedLSTMCell_0": cell}
  width = lstm
  for out in output_fc:
    encoder[f"Dense_{i}"], width, i = dense(width, out), out, i + 1
  return encoder, width


def numpy_rnn_trees(rng, obs_dim=4, num_actions=2):
  """Flax-shaped Q, value and categorical actor RNN trees at the factories'
  widths (input (40,), LSTM 40, output (40,)), drawn with numpy; the Q
  head is wide (U(±0.5)) so greedy actions are clear of rounding."""
  import numpy as np

  def head(width, out, scale):
    return {"kernel": rng.uniform(-scale, scale, (width, out)).astype(
        np.float32), "bias": rng.uniform(-0.05, 0.05, (out,)).astype(
            np.float32)}

  trees = {}
  for kind in ("q", "value", "actor"):
    encoder, width = numpy_lstm_encoder(rng, obs_dim)
    if kind == "q":
      tail = {"Dense_0": head(width, num_actions, 0.5)}
    elif kind == "value":
      tail = {"Dense_0": head(width, 1, 0.3)}
    else:
      tail = {"CategoricalProjection_0": {"Dense_0": head(width, num_actions,
                                                          0.1)}}
    trees[kind] = {"params": {"LSTMEncoderModule_0": encoder, **tail}}
  return trees


def rnn_networks(trees, device):
  """The port's Q, value and actor RNNs on `device` with the trees' weights."""
  import numpy as np

  from agents_tpu_torch.networks import (make_actor_distribution_rnn_network,
                                         make_q_rnn_network,
                                         make_value_rnn_network)
  from agents_tpu_torch.specs import array_spec
  from agents_tpu_torch.utils import convert

  obs = array_spec.ArraySpec((4,), np.float32)
  act = array_spec.BoundedArraySpec((), np.int32, 0, 1)
  nets = {"q": make_q_rnn_network(obs, act, device=device),
          "value": make_value_rnn_network(obs, device=device),
          "actor": make_actor_distribution_rnn_network(obs, act,
                                                       device=device)}
  converters = {"q": convert.q_rnn_params_to_state_dict,
                "value": convert.value_rnn_params_to_state_dict,
                "actor": convert.actor_rnn_params_to_state_dict}
  for kind, net in nets.items():
    net.load_state_dict(converters[kind](trees[kind]))
  return nets


def numpy_sequences(rng, batch, steps, obs_dim=4):
  """[B, T] CartPole-shaped sequences drawn with numpy: FIRST and LAST
  steps at scattered places, each LAST followed by a FIRST."""
  import numpy as np

  st = rng.choice([0, 1, 2], (batch, steps), p=[0.1, 0.8, 0.1])
  st[:, 1:][st[:, :-1] == 2] = 0
  nst = np.concatenate([st[:, 1:], rng.choice([1, 2], (batch, 1),
                                              p=[0.9, 0.1])], 1)
  return dict(
      step_type=st.astype(np.int32),
      observation=(rng.randn(batch, steps, obs_dim) * 0.5).astype(np.float32),
      action=rng.randint(0, 2, (batch, steps)).astype(np.int32),
      next_step_type=nst.astype(np.int32),
      reward=np.ones((batch, steps), np.float32),
      discount=np.where(nst == 2, rng.choice([0.0, 1.0], (batch, steps)),
                        1.0).astype(np.float32))


def rnn_network_parity(compare):
  """(a) of `phase_rnn_parity`: the three RNNs, card against CPU."""
  import numpy as np
  import torch

  trees = numpy_rnn_trees(np.random.RandomState(11))
  nets = {device: rnn_networks(trees, device) for device in ("cpu", "cuda")}
  rng = np.random.RandomState(12)
  seq = numpy_sequences(rng, RNN_PARITY_B, RNN_PARITY_T)
  carry = tuple(rng.randn(RNN_PARITY_B, 40).astype(np.float32)
                for _ in range(2))
  cases = {"step": (seq["observation"][:, 0], seq["step_type"][:, 0]),
           "sequence": (seq["observation"], seq["step_type"])}
  firsts = int((seq["step_type"] == 0).sum())
  for case, (obs, step_type) in cases.items():
    for start in ("zero", "carry"):
      outs = {}
      for device in ("cpu", "cuda"):
        to = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
        state = None if start == "zero" else tuple(map(to, carry))
        with torch.no_grad():
          outs[device] = {
              kind: net(to(obs), to(step_type), state)
              for kind, net in nets[device].items()}
      for kind in ("q", "value", "actor"):
        (gout, gcarry), (cout, ccarry) = outs["cuda"][kind], outs["cpu"][kind]
        tag = f"networks.{case}.{start}.{kind}"
        if kind == "actor":
          compare(f"{tag}.logits", gout.logits, cout.logits)
        else:
          compare(tag, gout, cout)
        compare.nests(f"{tag}.carry", gcarry, ccarry)
  return {"batch_size": RNN_PARITY_B, "steps": RNN_PARITY_T,
          "first_steps_in_sequences": firsts}


def build_rnn_dqn_agent(device, sequence_length=RNN_SEQUENCE):
  """Recurrent DDQN on CartPole's specs: `make_q_rnn_network` at its
  defaults and the CartPole example's settings (eps 0.1, gamma 0.99, tau
  0.05 every 5, Adam 1e-3, squared TD loss), trained on sequences of
  `sequence_length`."""
  import torch

  from agents_tpu_torch.agents.dqn import DdqnAgent
  from agents_tpu_torch.environments.classic import CartPole
  from agents_tpu_torch.networks import make_q_rnn_network
  from agents_tpu_torch.trajectories import time_step as ts
  from agents_tpu_torch.utils import common

  env = CartPole()
  tss = ts.time_step_spec(env.observation_spec())
  asp = env.action_spec()
  generator = torch.Generator(device=device)
  generator.manual_seed(0)
  qnet = make_q_rnn_network(tss.observation, asp, device=device,
                            generator=generator)
  return DdqnAgent(tss, asp, qnet, lambda p: torch.optim.Adam(p, lr=1e-3),
                   epsilon_greedy=0.1, gamma=0.99, target_update_tau=0.05,
                   target_update_period=5,
                   td_errors_loss_fn=common.element_wise_squared_loss,
                   train_sequence_length=sequence_length, device=device)


def build_rnn_dqn_loop(device, batch_size, capacity, sample_batch_size):
  """`build_rnn_dqn_agent`'s agent in the fused loop on B CartPoles."""
  from agents_tpu_torch import metrics
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import CartPole
  from agents_tpu_torch.replay_buffers import UniformReplay
  from agents_tpu_torch.train import FusedTrainLoop
  from agents_tpu_torch.trajectories import trajectory as tj

  env = BatchedTorchEnv(CartPole(), batch_size, device=device)
  agent = build_rnn_dqn_agent(device)
  replay = UniformReplay(
      tj.trajectory_spec(env.time_step_spec(), env.action_spec()), batch_size,
      capacity, device=device)
  return FusedTrainLoop(env, agent, replay,
                        metrics=metrics.standard_collect_metrics(20),
                        sample_batch_size=sample_batch_size, device=device)


def rnn_dqn_parity(compare):
  """(b) of `phase_rnn_parity`: recurrent DDQN train steps, each from the
  CPU's state."""
  import numpy as np
  import torch

  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils import convert, nest_utils

  tree = numpy_rnn_trees(np.random.RandomState(13))["q"]
  agents = {device: build_rnn_dqn_agent(device) for device in ("cpu", "cuda")}
  for agent in agents.values():
    agent.q_network.load_state_dict(convert.q_rnn_params_to_state_dict(tree))
  cstate, gstate = agents["cpu"].init(), agents["cuda"].init()
  rng = np.random.RandomState(14)
  losses, gaps = [], []
  for step in range(1, RNN_DQN_PARITY_STEPS + 1):
    batch = numpy_sequences(rng, RNN_DQN_PARITY_SAMPLE, RNN_SEQUENCE)
    cexp = tj.Trajectory(policy_info=(), **{k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    gexp = nest_utils.tree_map(lambda x: x.to("cuda"), cexp)
    gstate = load_agent_state(gstate, cstate)
    with torch.no_grad():
      q, _ = cstate.q_network(cexp.observation, cexp.step_type)
    top = torch.topk(q, 2, dim=-1).values
    gaps.append(float(((top[..., 0] - top[..., 1]) / q.abs().max()).min()))
    cstate, cinfo = agents["cpu"].train(cstate, cexp)
    gstate, ginfo = agents["cuda"].train(gstate, gexp)
    compare(f"dqn.step{step}.loss", ginfo.loss, cinfo.loss)
    compare(f"dqn.step{step}.td_loss", ginfo.extra.td_loss,
            cinfo.extra.td_loss)
    compare(f"dqn.step{step}.td_error", ginfo.extra.td_error,
            cinfo.extra.td_error)
    ctensors, gtensors = state_tensors(cstate), state_tensors(gstate)
    for k in ctensors:
      compare(f"dqn.step{step}.{k}", gtensors[k], ctensors[k])
    losses.append(float(ginfo.loss))
  return {"steps": RNN_DQN_PARITY_STEPS, "sample": RNN_DQN_PARITY_SAMPLE,
          "sequence_length": RNN_SEQUENCE, "losses": losses,
          "smallest_online_argmax_gap_of_max_abs_q": min(gaps)}


def rnn_ppo_parity(compare):
  """(c) of `phase_rnn_parity`: one recurrent PPO iteration of the
  `--preset=rnn` CartPole loop; the card unrolls its actor and value over
  the CPU's rollout (from the zero carry the rollout started from) and
  trains on it with the CPU's permutations, from the same initial
  state."""
  import numpy as np
  import torch

  from agents_tpu_torch.utils import convert, nest_utils
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws
  from examples.ppo_cartpole_torch import build_loop as ppo_loop
  from examples.ppo_cartpole_torch import parse_ppo_args

  cfg = parse_ppo_args(["--preset=rnn"])
  trees = numpy_rnn_trees(np.random.RandomState(15))
  loops = {}
  for device in ("cpu", "cuda"):
    loop = ppo_loop(dataclasses.replace(cfg, device=device))
    loop.agent.actor_network.load_state_dict(
        convert.actor_rnn_params_to_state_dict(trees["actor"]))
    loop.agent.value_network.load_state_dict(
        convert.value_rnn_params_to_state_dict(trees["value"]))
    loops[device] = loop
  cloop, gagent = loops["cpu"], loops["cuda"].agent
  draws = RecordingDraws(Draws(0, "cpu"))
  cstate, gstate = cloop.init(draws=draws), gagent.init()
  cstate, experience = cloop.collect(cstate)
  gexp = nest_utils.tree_map(lambda x: x.to("cuda"), experience)
  with torch.no_grad():
    obs = gagent.obs_normalizer.normalize(gstate.obs_norm_state,
                                          gexp.observation)
    dist, _ = gagent.actor_network(obs, gexp.step_type, ())
    value, _ = gagent.value_network(obs, gexp.step_type, ())
  compare("ppo.rollout.logits", dist.logits,
          experience.policy_info["dist"].logits)
  compare("ppo.rollout.value_prediction", value,
          experience.policy_info["value_prediction"])
  cagent_state, cinfo = cloop.agent.train(cstate.agent_state, experience,
                                          draws=draws)
  gstate, ginfo = gagent.train(gstate, gexp, draws=ReplayDraws(
      {"ppo_permutation": draws.records["ppo_permutation"]}, "cuda"))
  compare("ppo.loss", ginfo.loss, cinfo.loss)
  ctensors, gtensors = ppo_tensors(cagent_state), ppo_tensors(gstate)
  for k in ctensors:
    compare(f"ppo.{k}", gtensors[k], ctensors[k])
  return {"batch_size": cfg.env_batch_size,
          "rollout_length": cfg.rollout_length, "epochs": cfg.num_epochs,
          "minibatches": cfg.num_minibatches,
          "sequences_per_minibatch": cfg.env_batch_size // cfg.num_minibatches,
          "first_steps": int((experience.step_type == 0).sum()),
          "loss": float(ginfo.loss)}


# The LSTM kernel's three device functions, by a part of the names the
# trace gives them (`agents_tpu_torch/csrc/lstm_recurrence.cu`).
LSTM_KERNEL_FUNCTIONS = {"forward": "forward_step<",
                         "backward": "backward_step<",
                         "start": "backward_start("}


@contextlib.contextmanager
def lstm_recorded(counts):
  """Zeroes the LSTM kernel's launch count (`KERNEL.launches`) and records
  spans and counters over the block; afterwards `counts` holds the
  launches, the forward steps of every unroll (`lstm.steps`, counted on
  either path), those that ran the kernel (`lstm.kernel_steps`), the
  backward steps (`lstm.backward_steps`), and the unrolls and backwards
  (calls of the `lstm.unroll` and `lstm.backward` spans). A
  `profile_window` inside the block joins its recording."""
  from agents_tpu_torch.ops.lstm_recurrence import KERNEL
  from agents_tpu_torch.utils import profiling

  KERNEL.launches = 0
  with profiling.record() as rec:
    yield counts
  out = rec.summary()
  counters, spans = out["counters"], out["spans"]
  counts.update(
      launches=KERNEL.launches, steps=counters.get("lstm.steps", 0),
      kernel_steps=counters.get("lstm.kernel_steps", 0),
      backward_steps=counters.get("lstm.backward_steps", 0),
      unrolls=spans.get("lstm.unroll", {}).get("calls", 0),
      backwards=spans.get("lstm.backward", {}).get("calls", 0))


def lstm_launch_checks(counts, units, device_calls=None):
  """Whether the stretch that `lstm_recorded` filled `counts` over ran
  every step of the LSTM on its kernel, one launch a forward or backward
  step and one for each backward's start, and launched at all; with
  `device_calls` (`profile_window`'s count of `LSTM_KERNEL_FUNCTIONS`),
  whether the trace shows the card running each function that was
  launched, and none more often than it was launched (the profiler can
  drop an event: it read 104 of 105 forward steps once, exactly in other
  runs). Returns (the fields to emit, per unit of work and per unroll;
  ok)."""
  launches = counts["launches"]
  checks = {
      "launched": launches > 0,
      "every_step_on_the_kernel": counts["kernel_steps"] == counts["steps"],
      "one_launch_a_step_and_one_a_backward": launches == (
          counts["steps"] + counts["backward_steps"] + counts["backwards"])}
  if device_calls is not None:
    launched = {"forward": counts["steps"],
                "backward": counts["backward_steps"],
                "start": counts["backwards"]}
    checks["card_ran_the_launches"] = all(
        (device_calls[k] > 0) == (n > 0) and device_calls[k] <= n
        for k, n in launched.items())
  fields = dict(counts, units=units, launches_per_unit=launches / units,
                launches_per_unroll=launches / max(counts["unrolls"], 1),
                device_calls=device_calls, checks=checks)
  return fields, all(checks.values())


def phase_rnn_parity(card):
  """The recurrent networks, recurrent DDQN and recurrent PPO, card
  against CPU (TF32 off), each tensor to max|card - cpu| <= 1e-5 + 1e-4
  max|cpu|; integers and step types equal. Every forward step of an
  unroll on the card runs the LSTM kernel, and every one on the CPU the
  plain loop (the unroll's route, watched, gives each side's steps)."""
  import torch

  from agents_tpu_torch.networks import lstm_networks

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  compare = BoundedComparison(RNN_RTOL, RNN_ATOL)
  routed, route, lstm = {"cuda": 0, "cpu": 0}, lstm_networks._on_kernel, {}

  def watched(x):
    routed[x.device.type] += x.shape[1]
    return route(x)

  lstm_networks._on_kernel = watched
  try:
    with lstm_recorded(lstm):
      networks = rnn_network_parity(compare)
      dqn = rnn_dqn_parity(compare)
      ppo = rnn_ppo_parity(compare)
  finally:
    lstm_networks._on_kernel = route
  kernel_checks = {
      "launched": lstm["launches"] > 0,
      "card_steps_on_the_kernel": lstm["kernel_steps"] == routed["cuda"] > 0,
      "cpu_steps_on_the_plain_loop": (lstm["steps"] - lstm["kernel_steps"]
                                      == routed["cpu"])}
  # DDQN's online argmax is discontinuous: the numpy-made batches must keep
  # every choice clear of rounding, as QtOpt's elites are held.
  ok = (not compare.mismatched
        and dqn["smallest_online_argmax_gap_of_max_abs_q"] > RNN_ARGMAX_GAP
        and all(kernel_checks.values()))
  emit("rnn_parity", card=card, widths={"input": [40], "lstm": 40,
                                        "output": [40]},
       networks=networks, ddqn=dqn, ppo=ppo, rtol=RNN_RTOL, atol=RNN_ATOL,
       criterion="max|card - cpu| <= atol + rtol * max|cpu| per tensor; "
       "each DDQN step from the CPU's state",
       lstm_kernel=dict(lstm, card_steps=routed["cuda"],
                        cpu_steps=routed["cpu"], checks=kernel_checks),
       **compare.summary(), ok=ok)
  if not ok:
    fail("rnn_parity", "card and CPU disagree on the recurrent path, or a "
         f"card unroll missed the LSTM kernel: {kernel_checks}")


# The LSTM kernel at R2D2's shapes: (rows, steps, with gradient) of its
# main path's unrolls; H = 512, 531 inputs; repeats timed per case.
LSTM_KERNEL_SIZE, LSTM_KERNEL_INPUTS = 512, 531
LSTM_KERNEL_CASES = {"trained": (64, 80, True), "burn_in": (64, 40, False),
                     "collect": (256, 1, False)}
LSTM_KERNEL_REPEATS = 20
LSTM_KERNEL_RTOL, LSTM_KERNEL_ATOL = 1e-4, 1e-5
FP32_PEAK, HBM_BYTES_PER_S = 67e12, 3.35e12


def lstm_least_ms(rows, steps, size, grads):
  """Least time of an unroll's recurrence (and its backward): each step's
  ``[rows, H] x [H, 4H]`` product with its reads and writes, at the fp32
  peak and HBM bandwidth (`portbench/lstm.py`'s count)."""
  product = 2 * rows * size * 4 * size
  nbytes = 4 * (4 * size * size + rows * 4 * size + 5 * rows * size)
  step = max(product / FP32_PEAK, nbytes / HBM_BYTES_PER_S)
  total = steps * step * (2 if grads else 1)
  if grads:
    total += max(2 * steps * rows * 4 * size * size / FP32_PEAK,
                 4 * (steps * rows * 5 * size + 4 * size * size)
                 / HBM_BYTES_PER_S)
  return total * 1e3


def phase_lstm_kernel(card):
  """45a: the LSTM recurrence's kernel against the plain loop and cuDNN's
  LSTM at R2D2's shapes; returns the kernel table's row."""
  import numpy as np
  import torch
  import torch.nn.functional as F

  from agents_tpu_torch.networks import lstm_networks
  from agents_tpu_torch.ops.lstm_recurrence import KERNEL

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  size, width = LSTM_KERNEL_SIZE, LSTM_KERNEL_INPUTS
  rng = np.random.RandomState(22)
  to = lambda x: torch.from_numpy(x.astype(np.float32)).cuda()  # noqa: E731
  w_i = to(rng.randn(4 * size, width) / np.sqrt(width))
  bias = to(rng.randn(4 * size) * 0.1)
  w_h = to(rng.randn(4 * size, size) / np.sqrt(size))

  def unroll(leaves, keep, grads):
    """The masked unroll of leaves (gates_x, w_h, c, h), with the gradients
    of a loss on its outputs and final carry when `grads`."""
    gates_x, w, c, h = leaves
    y, c, h = lstm_networks._MaskedLSTMUnroll.apply(gates_x, keep, w, c, h,
                                                    grads)
    if not grads:
      return [y, c, h]
    loss = y.square().sum() + c.sum() + h.sum()
    return [y, c, h] + list(torch.autograd.grad(loss, leaves))

  @contextlib.contextmanager
  def plain():
    route = lstm_networks._on_kernel
    lstm_networks._on_kernel = lambda x: False
    try:
      yield
    finally:
      lstm_networks._on_kernel = route

  def event_ms(fn):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(LSTM_KERNEL_REPEATS):
      fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / LSTM_KERNEL_REPEATS

  t0 = time.perf_counter()
  first = None
  cases, gaps, ok = {}, {}, True
  for name, (rows, steps, grads) in LSTM_KERNEL_CASES.items():
    x = to(rng.randn(rows, steps, width) * 0.5)
    keep = to((rng.rand(rows, steps) > 0.02).astype(np.float32))
    c, h = to(rng.randn(rows, size) * 0.5), to(rng.randn(rows, size) * 0.5)
    with torch.set_grad_enabled(grads):
      gates_x = F.linear(x, w_i, bias).detach()
      leaves = [t.clone().requires_grad_(grads) for t in (gates_x, w_h, c, h)]
      launches = KERNEL.launches
      got = unroll(leaves, keep, grads)
      torch.cuda.synchronize()
      launches = KERNEL.launches - launches
      ok &= launches == (2 * steps + 1 if grads else steps)
      if first is None:
        first = time.perf_counter() - t0
      with plain():
        want = unroll(leaves, keep, grads)
      gaps[name] = {}
      for tag, a, b in zip(("outputs", "c", "h", "d_gates_x", "d_w_h",
                            "d_c", "d_h"), got, want):
        scale = b.abs().max().item()
        gap = (a - b).abs().max().item()
        gaps[name][tag] = gap / scale
        ok &= gap <= LSTM_KERNEL_ATOL + LSTM_KERNEL_RTOL * scale
      kernel_ms = event_ms(lambda: unroll(leaves, keep, grads))
      with plain():
        plain_ms = event_ms(lambda: unroll(leaves, keep, grads))
      lstm = torch.nn.LSTM(width, size, batch_first=True).cuda()
      lstm.requires_grad_(grads)
      inputs = [t.clone().requires_grad_(grads) for t in (w_i, bias)]
      carry = (h[None].contiguous(), c[None].contiguous())

      def library():
        y, (hn, cn) = lstm(x, carry)
        if grads:
          torch.autograd.grad(y.square().sum() + cn.sum() + hn.sum(),
                              list(lstm.parameters()))

      def input_product():
        gates = F.linear(x, *inputs)
        if grads:
          torch.autograd.grad(gates.sum(), inputs)

      library_ms = event_ms(library)
      input_ms = event_ms(input_product)
    cases[name] = dict(
        rows=rows, steps=steps, gradient=grads, kernel_ms=kernel_ms,
        bound_ms=lstm_least_ms(rows, steps, size, grads), plain_ms=plain_ms,
        library_ms=library_ms, input_product_ms=input_ms, launches=launches)
  row = {"name": "lstm_recurrence", "replaces": "agents_tpu/networks/"
         "lstm_networks.py: the masked LSTM's lax.scan (no Pallas kernel)",
         "source": "agents_tpu_torch/csrc/lstm_recurrence.cu",
         "route": "CUDA C++, nvcc sm_90a, ctypes",
         **{f"{name}_{k}": v for name, case in cases.items()
            for k, v in case.items() if k.endswith("_ms")}}
  emit("lstm_kernel", card=card, size=size, inputs=width, cases=cases,
       relative_gaps=gaps, rtol=LSTM_KERNEL_RTOL, atol=LSTM_KERNEL_ATOL,
       first_call_s=first,
       note="library_ms runs the input product too (input_product_ms); "
       "launches: the kernel's count over one call of each case",
       ok=ok)
  if not ok:
    fail("lstm_kernel", "the kernel disagrees with the plain loop or "
         "launched other than once a step")
  return row


def phase_rnn_dqn_main(card):
  """The CartPole bench point with the recurrent Q network (DDQN,
  sequences of 10): a sync-checked stretch, then a short profile whose
  kernels show the LSTM kernel's launches on the card."""
  import torch

  from agents_tpu_torch.ops.lstm_recurrence import KERNEL

  loop = build_rnn_dqn_loop("cuda", B_MAIN, MAIN["capacity"],
                            MAIN["sample_batch_size"])
  state = loop.init(seed=0, initial_collect_steps=100)
  state, losses = loop.run(state, RNN_DQN_WARMUP)
  KERNEL.launches = 0
  state, losses = sync_checked(loop.run, state, RNN_DQN_CHECKED)
  checked_launches = KERNEL.launches / RNN_DQN_CHECKED
  iterations = RNN_DQN_WARMUP + RNN_DQN_CHECKED
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  finite = bool(torch.isfinite(losses).all())
  bad_transitions, lasts = check_step_types(loop, state)
  carry = [tuple(c.shape) for c in state.driver_state.policy_state]
  ok = (not off_card and finite and bad_transitions == 0
        and state.replay_state.count == 100 + iterations
        and state.agent_state.train_step == iterations
        and carry == [(B_MAIN, 40)] * 2)
  # The profiled iterations: the LSTM's launches against the unrolls'
  # steps and the kernels the card ran; every iteration launches alike.
  lstm = {}
  with lstm_recorded(lstm):
    state, prof = profile_window(loop, state, RNN_DQN_PROFILED,
                                 device_names=LSTM_KERNEL_FUNCTIONS)
  lstm, lstm_ok = lstm_launch_checks(lstm, RNN_DQN_PROFILED,
                                     prof["device_calls"])
  lstm["checked_launches_per_unit"] = checked_launches
  ok = ok and lstm_ok and checked_launches == lstm["launches_per_unit"]
  emit("rnn_dqn_main", card=card, agent="DdqnAgent", batch_size=B_MAIN,
       ring=MAIN["capacity"], sample_batch_size=MAIN["sample_batch_size"],
       sequence_length=RNN_SEQUENCE,
       widths={"input": [40], "lstm": 40, "output": [40]},
       sync_debug_mode="error", warmup_iterations=RNN_DQN_WARMUP,
       checked_iterations=RNN_DQN_CHECKED, profile=prof,
       tensors_off_card=off_card, losses_finite=finite,
       last_loss=float(losses[-1]), replay_count=state.replay_state.count,
       illegal_step_type_transitions=bad_transitions,
       last_frames_in_ring=lasts, carry_shapes=carry, lstm_kernel=lstm,
       ok=ok)
  if not ok:
    fail("rnn_dqn_main", "recurrent DQN bench point checks failed")


def phase_ppo_rnn_main(card):
  """`examples/ppo_cartpole_torch.py --preset=rnn`: a sync-checked
  iteration whose unrolls run on the LSTM kernel, then a rollout's
  checks."""
  import torch

  from agents_tpu_torch.utils import nest_utils
  from examples.ppo_cartpole_torch import build_loop as ppo_loop
  from examples.ppo_cartpole_torch import parse_ppo_args

  cfg = parse_ppo_args(["--preset=rnn"])
  loop = ppo_loop(cfg)
  state = loop.init(cfg.seed)
  state, losses = loop.run(state, PPO_RNN_WARMUP)
  lstm = {}
  with lstm_recorded(lstm):
    state, losses = sync_checked(loop.run, state, PPO_RNN_CHECKED)
  lstm, lstm_ok = lstm_launch_checks(lstm, PPO_RNN_CHECKED)
  off_card = [tuple(t.shape) for t in loop_tensors(state)
              if t.device.type != "cuda"]
  finite = bool(torch.isfinite(losses).all())
  state, experience = loop.collect(state)
  rollout = rollout_checks(experience)
  iterations = PPO_RNN_WARMUP + PPO_RNN_CHECKED
  carry = [tuple(c.shape) for c in
           nest_utils.flatten(state.driver_state.policy_state)]
  ok = (not off_card and finite and rollout["illegal_step_type_transitions"]
        == 0 and state.agent_state.train_step == iterations
        and carry == [(cfg.env_batch_size, cfg.lstm_size)] * 4 and lstm_ok)
  emit("ppo_rnn_main", card=card, batch_size=cfg.env_batch_size,
       rollout_length=cfg.rollout_length, epochs=cfg.num_epochs,
       minibatches=cfg.num_minibatches,
       sequences_per_minibatch=cfg.env_batch_size // cfg.num_minibatches,
       widths={"input": list(cfg.actor_fc_layers), "lstm": cfg.lstm_size,
               "output": list(cfg.lstm_output_fc_layers)},
       sync_debug_mode="error", warmup_iterations=PPO_RNN_WARMUP,
       checked_iterations=PPO_RNN_CHECKED, tensors_off_card=off_card,
       losses_finite=finite, last_loss=float(losses[-1]), rollout=rollout,
       carry_shapes=carry, train_step=state.agent_state.train_step,
       lstm_kernel=lstm, ok=ok)
  if not ok:
    fail("ppo_rnn_main", "recurrent PPO CartPole point checks failed")


def phase_ppo_rnn_learn(card):
  """`--preset=rnn_learn` (`tests/test_ppo_rnn.py`'s config) for its 30
  iterations to a last-20 return above the bar, then greedy eval over
  exactly 30 episodes."""
  import torch

  from examples.ppo_cartpole_torch import build_loop as ppo_loop
  from examples.ppo_cartpole_torch import evaluate, parse_ppo_args

  cfg = parse_ppo_args(["--preset=rnn_learn"])
  loop = ppo_loop(cfg)
  state = loop.init(cfg.seed)
  iterations, points, lstm = 0, [], {}
  with lstm_recorded(lstm):
    while iterations < cfg.num_iterations:
      state, losses = loop.run(state, PPO_RNN_LEARN_CHUNK)
      iterations += PPO_RNN_LEARN_CHUNK
      points.append([iterations,
                     float(loop.results(state)["AverageReturn"])])
  lstm, lstm_ok = lstm_launch_checks(lstm, iterations)
  ret = points[-1][1]
  out = evaluate(cfg, loop, state, cfg.seed + 101, 30)
  episodes = int(out["NumberOfEpisodes"])
  finite = bool(torch.isfinite(losses).all())
  ok = ret > PPO_RNN_LEARN_GATE and finite and episodes == 30 and lstm_ok
  emit("ppo_rnn_learn", card=card, batch_size=cfg.env_batch_size,
       rollout_length=cfg.rollout_length, epochs=cfg.num_epochs,
       minibatches=cfg.num_minibatches,
       widths={"input": list(cfg.actor_fc_layers), "lstm": cfg.lstm_size,
               "output": list(cfg.lstm_output_fc_layers)},
       iterations=iterations, last20_average_return=ret,
       gate=PPO_RNN_LEARN_GATE, points=points, losses_finite=finite,
       eval_episodes=episodes, eval_envs=cfg.num_eval_envs,
       eval_average_return=float(out["AverageReturn"]),
       eval_average_episode_length=float(out["AverageEpisodeLength"]),
       lstm_kernel=lstm, ok=ok)
  if not ok:
    fail("ppo_rnn_learn", f"last-20 return {ret} (gate > "
         f"{PPO_RNN_LEARN_GATE} within {cfg.num_iterations} iterations), "
         f"{episodes} eval episodes of 30, LSTM kernel {lstm['checks']}")


def nest_mismatches(a, b, path="state"):
  """The paths where two `checkpointer.capture`s differ (tensors by
  `torch.equal`, anything else by ==)."""
  import torch

  if type(a) is not type(b):
    return [path]
  if isinstance(a, torch.Tensor):
    return [] if a.dtype == b.dtype and torch.equal(a, b) else [path]
  if isinstance(a, dict):
    if list(a) != list(b):
      return [path]
    return [p for k in a for p in nest_mismatches(a[k], b[k],
                                                  f"{path}.{k}")]
  if isinstance(a, (list, tuple)):
    if len(a) != len(b):
      return [path]
    return [p for i, (x, y) in enumerate(zip(a, b))
            for p in nest_mismatches(x, y, f"{path}[{i}]")]
  return [] if a == b else [path]


def resume_case(build, init, iterations, directory):
  """`iterations` + `iterations` without a break, against `iterations`,
  a save, a fresh loop from the same seed, a restore and `iterations`
  more: whether the losses and every part of the final states are equal,
  with the checkpoint's bytes."""
  import torch

  from agents_tpu_torch.train import Checkpointer
  from agents_tpu_torch.train.checkpointer import capture
  from agents_tpu_torch.utils import nest_utils

  loop = build()
  state, first = loop.run(init(loop), iterations)
  state, second = loop.run(state, iterations)
  whole, final = torch.cat([first, second]), capture(state)
  del loop, state

  loop = build()
  state, first = loop.run(init(loop), iterations)
  checkpointer = Checkpointer(directory)
  checkpointer.save(iterations, state)
  carry = [c.clone()
           for c in nest_utils.flatten(state.driver_state.policy_state)]
  del loop, state

  loop = build()
  restored = checkpointer.restore(init(loop))
  carry_equal = all(torch.equal(a, b) for a, b in zip(
      nest_utils.flatten(restored.driver_state.policy_state), carry,
      strict=True))
  restored, second = loop.run(restored, iterations)
  resumed = torch.cat([first, second])
  mismatched = nest_mismatches(final, capture(restored))
  on_card = restored.agent_state.train_step > 0 and all(
      t.device.type == "cuda" for t in loop_tensors(restored))
  path = os.path.join(directory, f"{iterations}.pt")
  return {"iterations": [iterations, iterations],
          "losses_equal": bool(torch.equal(whole, resumed)),
          "losses_finite": bool(torch.isfinite(resumed).all()),
          "state_mismatched": mismatched[:10],
          "carry_restored": carry_equal, "tensors_on_card": on_card,
          "checkpoint_bytes": os.path.getsize(path),
          "ok": (bool(torch.equal(whole, resumed)) and not mismatched
                 and carry_equal and on_card)}


def phase_checkpoint_resume(card):
  """Save, rebuild, restore and continue on the card, bit for bit against
  the run without a break: (a) fused DQN at the CartPole bench point, (b)
  recurrent PPO at `--preset=rnn_learn` (the LSTM carry and the episodes
  in flight), (c) SAC at the `sac_parity` config (three Adams and log
  alpha), (d) the PER loop at the bench point (priorities, max priority
  and the host count)."""
  from examples.ppo_cartpole_torch import build_loop as ppo_loop
  from examples.ppo_cartpole_torch import parse_ppo_args
  from examples.sac_pendulum_torch import Config as SacConfig
  from examples.sac_pendulum_torch import build_loop as sac_loop

  ppo_cfg = parse_ppo_args(["--preset=rnn_learn"])
  sac_cfg = SacConfig(**SAC_PARITY)
  cases = {
      "dqn_bench_point": (
          lambda: build_loop("cuda", B_MAIN, **MAIN),
          lambda loop: loop.init(seed=0, initial_collect_steps=100),
          CKPT_DQN_ITERATIONS),
      "ppo_rnn": (lambda: ppo_loop(ppo_cfg),
                  lambda loop: loop.init(ppo_cfg.seed), CKPT_PPO_ITERATIONS),
      "sac": (lambda: sac_loop(sac_cfg),
              lambda loop: loop.init(seed=0, initial_collect_steps=16),
              CKPT_SAC_ITERATIONS),
      "per_bench_point": (
          lambda: build_per_loop("cuda", B_MAIN, **MAIN),
          lambda loop: loop.init(seed=0, initial_collect_steps=100),
          CKPT_DQN_ITERATIONS)}
  out = {}
  with tempfile.TemporaryDirectory() as tmp:
    for name, (build, init, iterations) in cases.items():
      out[name] = resume_case(build, init, iterations,
                              os.path.join(tmp, name))
      free_card()
  ok = all(case["ok"] for case in out.values())
  emit("checkpoint_resume", card=card, criterion="torch.equal of the losses "
       "and of every tensor, number and generator state of the final state",
       **out, ok=ok)
  if not ok:
    fail("checkpoint_resume", "a resumed run differs from the run without "
         "a break")


# -- host environments and the host-device loops -------------------------------

HOST_PARITY = dict(env_batch_size=8, replay_capacity=64, sample_batch_size=32,
                   train_steps_per_call=2)
HOST_PARITY_RANDOM, HOST_PARITY_TICKS = 4, 3
# The per-tensor bound of the PPO, CQL and QtOpt parity phases, for the
# networks and Adam moments (PERF.md §6).
HOST_PARITY_TENSOR_RTOL = 1e-4
# Ticks and iterations whose host syncs are counted; the host loops have
# no periodic branch.
HOST_SAC_WARMUP, HOST_SAC_COUNTED = 2, 2
HOST_PPO_WARMUP, HOST_PPO_COUNTED = 1, 1
PARALLEL_WORKERS, PARALLEL_STEPS = 4, 50
ASYNC_RESUME = dict(env_batch_size=8, replay_capacity=256,
                    sample_batch_size=32, train_steps_per_call=4,
                    utd_ratio=1.0, initial_collect_ticks=4)
ASYNC_RESUME_TICKS, ASYNC_RESUME_MORE, ASYNC_RESUME_EVERY = 60, 90, 25


def halfcheetah_factory(**kwargs):
  """A `make_env` for the examples: each call a new seed."""
  seeds = iter(range(10**6))
  return lambda: random_halfcheetah(next(seeds), **kwargs)


def sac_config(**fields):
  from examples.sac_halfcheetah_torch import Config
  return Config(**fields)


def sync_sac_loop(cfg, device, env_kwargs=None):
  """`HostDeviceTrainLoop` over `cfg.env_batch_size` random HalfCheetahs
  with the SAC agent and replay of `examples/sac_halfcheetah_torch.py`."""
  from agents_tpu_torch.environments.batched_py_environment import \
      BatchedPyEnvironment
  from agents_tpu_torch.metrics import py_metrics
  from agents_tpu_torch.train import HostDeviceTrainLoop
  from examples.sac_halfcheetah_torch import build_agent

  env = BatchedPyEnvironment([random_halfcheetah(i, **(env_kwargs or {}))
                              for i in range(cfg.env_batch_size)])
  agent, replay = build_agent(cfg, env, device)
  return HostDeviceTrainLoop(
      env, agent, replay, train_steps_per_tick=cfg.train_steps_per_call,
      sample_batch_size=cfg.sample_batch_size,
      py_metrics=[py_metrics.AverageReturnMetric(20),
                  py_metrics.EnvironmentSteps(),
                  py_metrics.NumberOfEpisodes()], device=device)


SYNC_SITES = {}


@contextlib.contextmanager
def recorded_syncs(counts):
  """Within it, ``set_sync_debug_mode("warn")``, and each synchronizing
  CUDA operation counted into `counts` ({thread name: {file:line: n}}) in
  the thread that made it."""
  import threading
  import warnings

  import torch

  def record(message, category, filename, lineno, file=None, line=None):
    del category, file, line
    if "synchroniz" in str(message):
      per = counts.setdefault(threading.current_thread().name, {})
      site = f"{os.path.relpath(filename)}:{lineno}"
      per[site] = per.get(site, 0) + 1

  with warnings.catch_warnings():
    warnings.simplefilter("always")
    warnings.showwarning = record
    torch.cuda.set_sync_debug_mode("warn")
    try:
      yield counts
    finally:
      torch.cuda.set_sync_debug_mode(0)


def count_syncs(fn):
  """`fn()` under ``set_sync_debug_mode("warn")``: (its result, the number
  of synchronizing CUDA operations it made). Each one's Python site
  (file:line) is tallied in `SYNC_SITES`."""
  counts = {}
  with recorded_syncs(counts):
    result = fn()
  total = 0
  for sites in counts.values():
    for site, n in sites.items():
      SYNC_SITES[site] = SYNC_SITES.get(site, 0) + n
      total += n
  return result, total


def phase_host_parity(card):
  """`HostDeviceTrainLoop` SAC at (256, 256) on the CPU and on the card from
  numpy-made params and one replayed stream of draws (TF32 off)."""
  import numpy as np
  import torch

  from agents_tpu_torch.utils import convert, nest_utils
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  cfg = sac_config(**HOST_PARITY)
  actor, critic1, critic2 = numpy_sac_params(
      np.random.RandomState(5), cfg.actor_fc_layers,
      cfg.critic_joint_fc_layers, HALFCHEETAH_OBS, HALFCHEETAH_ACT)
  runs, records = {}, None
  for device in ("cpu", "cuda"):
    loop = sync_sac_loop(cfg, device, {"episode_end_probability": 0.3})
    agent = loop.agent
    agent.actor_network.load_state_dict(
        convert.sac_actor_params_to_state_dict(actor))
    agent.critic_network.load_state_dict(
        convert.sac_critic_params_to_state_dict(critic1))
    agent.critic_network_2.load_state_dict(
        convert.sac_critic_params_to_state_dict(critic2))
    draws = (RecordingDraws(Draws(0, "cpu")) if device == "cpu"
             else ReplayDraws(records, device))
    dev, time_step = loop.init(draws=draws)
    dev = dataclasses.replace(dev, agent_state=dataclasses.replace(
        dev.agent_state, draws=draws))
    dev, time_step, prev, action = loop.collect(
        dev, time_step, HOST_PARITY_RANDOM, seed=3)
    dev, time_step, prev, action, loss = loop.run(
        dev, time_step, prev, action, HOST_PARITY_TICKS)
    if device == "cpu":
      records = draws.records
    runs[device] = (loop, dev, time_step, action, loss)
  (cloop, cdev, cts, caction, closs), (gloop, gdev, gts, gaction, gloss) = (
      runs["cpu"], runs["cuda"])
  diffs, mismatched, beyond_elementwise = {}, [], []

  def compare(name, a, b, per_tensor=False):
    """Elementwise within SAC's rtol / atol; with `per_tensor` (networks
    and Adam moments, where Adam turns rounding in a near-cancelling
    gradient into a step of up to the learning rate) max|card - cpu| <=
    atol + HOST_PARITY_TENSOR_RTOL * max|cpu|."""
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    if not a.dtype.is_floating_point:
      if not torch.equal(a, b):
        mismatched.append(name)
      return
    diffs[name] = max_diff(a, b)
    if torch.allclose(a, b, rtol=SAC_RTOL, atol=SAC_ATOL):
      return
    beyond_elementwise.append(name)
    bound = SAC_ATOL + HOST_PARITY_TENSOR_RTOL * float(a.abs().max())
    if not per_tensor or diffs[name] > bound:
      mismatched.append(name)

  compare("loss", torch.tensor(closs), torch.tensor(gloss))
  ctensors, gtensors = (state_tensors(cdev.agent_state),
                        state_tensors(gdev.agent_state))
  for k in ctensors:
    compare(k, ctensors[k], gtensors[k], per_tensor=k not in ("log_alpha",))
  names = ["step_type", "observation", "action", "next_step_type", "reward",
           "discount"]
  for name, a, b in zip(names, nest_utils.flatten(cdev.replay_state.storage),
                        nest_utils.flatten(gdev.replay_state.storage)):
    compare(f"replay.{name}", a, b)
  compare("last_action", caction, gaction)
  for a, b in zip(nest_utils.flatten(cts), nest_utils.flatten(gts)):
    compare("time_step", a, b)
  cres, gres = cloop.metric_results(), gloop.metric_results()
  if cres != gres:
    mismatched.append("py_metrics")
  if cdev.replay_state.count != gdev.replay_state.count:
    mismatched.append("replay.count")
  worst = max(diffs, key=diffs.get)
  ok = (not mismatched and sum(draws.remaining().values()) == 0
        and gdev.agent_state.train_step
        == HOST_PARITY_TICKS * cfg.train_steps_per_call)
  emit("host_parity", card=card, env="RandomPyEnvironment x "
       f"{cfg.env_batch_size} (HalfCheetah-v5 specs)",
       actor=list(cfg.actor_fc_layers), critic=list(cfg.critic_joint_fc_layers),
       ring=cfg.replay_capacity, sample=cfg.sample_batch_size,
       train_steps_per_tick=cfg.train_steps_per_call,
       random_ticks=HOST_PARITY_RANDOM, ticks=HOST_PARITY_TICKS,
       rtol=SAC_RTOL, atol=SAC_ATOL,
       per_tensor_rtol=HOST_PARITY_TENSOR_RTOL,
       largest_float_diff={"name": worst, "abs": diffs[worst]},
       beyond_elementwise=beyond_elementwise,
       loss=[closs, gloss], compared=len(diffs), py_metrics=gres,
       draws_left=sum(draws.remaining().values()), mismatched=mismatched,
       ok=ok)
  if not ok:
    fail("host_parity", f"card and CPU disagree on {mismatched}")


def phase_host_sac_main(card):
  """The sync host loop at `bench.py:sac_live_probe`'s point: the port's
  host syncs over a stretch of ticks, one per tick."""
  from agents_tpu_torch.utils import nest_utils

  cfg = sac_config(**SAC_POINT)
  loop = sync_sac_loop(cfg, "cuda")
  B, K = cfg.env_batch_size, cfg.train_steps_per_call
  dev, time_step = loop.init(seed=cfg.seed)
  dev, time_step, prev, action = loop.collect(
      dev, time_step, cfg.initial_collect_ticks, seed=cfg.seed)
  dev, time_step, prev, action, loss = loop.run(dev, time_step, prev, action,
                                                HOST_SAC_WARMUP)
  SYNC_SITES.clear()
  (dev, time_step, prev, action, loss), syncs = count_syncs(
      lambda: loop.run(dev, time_step, prev, action, HOST_SAC_COUNTED))
  sync_sites = dict(SYNC_SITES)
  ticks = HOST_SAC_WARMUP + HOST_SAC_COUNTED
  expected_count = cfg.initial_collect_ticks - 1 + ticks
  off_card = [name for name, t in state_tensors(dev.agent_state).items()
              if t.device.type != "cuda" and name != "train_step"
              and not name.endswith(".step")]
  off_card += [str(tuple(t.shape)) for t in nest_utils.flatten(
      dev.replay_state.storage) if t.device.type != "cuda"]
  log_alpha = float(dev.agent_state.log_alpha.detach())
  # The port's syncs: one action read per tick and one loss read per
  # `run`; a sync inside torch's own CUDA module is the debug mode's, not
  # the loop's.
  port_syncs = sum(n for site, n in sync_sites.items()
                   if site.startswith("agents_tpu_torch"))
  syncs_per_tick = (port_syncs - 1) / HOST_SAC_COUNTED
  ok = (math.isfinite(loss) and math.isfinite(log_alpha) and not off_card
        and syncs_per_tick == 1.0
        and dev.replay_state.count == expected_count
        and dev.agent_state.train_step == ticks * K
        and loop.metric_results()["EnvironmentSteps"]
        == (cfg.initial_collect_ticks + ticks) * B)
  emit("host_sac_main", card=card, env=f"RandomPyEnvironment x {B} "
       "(HalfCheetah-v5 specs, thread pool)", batch_size=B,
       ring=cfg.replay_capacity, sample_batch_size=cfg.sample_batch_size,
       actor=list(cfg.actor_fc_layers), critic=list(cfg.critic_joint_fc_layers),
       train_steps_per_tick=K, reward_scale=cfg.reward_scale_factor,
       counted_ticks=HOST_SAC_COUNTED, host_syncs=syncs,
       host_sync_sites=sync_sites, host_syncs_per_tick=syncs_per_tick,
       sync_note="sync debug mode 'warn'; the port's sites, less one loss "
                 "read per run()",
       last_loss=loss, log_alpha=log_alpha,
       replay_count=dev.replay_state.count,
       expected_replay_count=expected_count,
       train_step=dev.agent_state.train_step, tensors_off_card=off_card,
       ok=ok)
  loop.env.close()
  if not ok:
    fail("host_sac_main", "host SAC point checks failed")


def phase_async_sac_main(card):
  """`bench_torch.py:sac_live_probe` at one ramp run and its minimum of
  1,200 timed ticks: rates, realized UTD and the collector's tick with and
  without the trainer, gated on the probe's checks."""
  t_phase = time.perf_counter()
  probe = sac_live_probe(seconds=0.0, max_ramp_runs=1, device="cuda")
  checks = probe.pop("checks")
  ok = all(checks.values())
  emit("async_sac_main", card=card, **probe,
       batch_size=SAC_POINT["env_batch_size"],
       ring=SAC_POINT["replay_capacity"],
       sample_batch_size=SAC_POINT["sample_batch_size"],
       train_steps_per_call=SAC_POINT["train_steps_per_call"],
       utd_ratio=SAC_POINT["utd_ratio"],
       min_replay_frames=(SAC_POINT["initial_collect_ticks"]
                          * SAC_POINT["env_batch_size"]),
       cut=f"1 ramp run (up to 6); timed run {SAC_MIN_TICKS:,} ticks, the "
           "probe's minimum (bench.py:120)",
       probe_guard_utd=0.8, checks=checks,
       seconds=time.perf_counter() - t_phase, ok=ok)
  if not ok:
    fail("async_sac_main", f"async loop checks failed: {checks}")


def phase_host_ppo_main(card):
  """`HostOnPolicyTrainLoop` at `examples/ppo_halfcheetah.py`'s schulman17
  config over a random HalfCheetah: host syncs per collect counted."""
  from agents_tpu_torch.utils.draws import Draws
  from examples.ppo_halfcheetah_torch import Config
  from examples.ppo_halfcheetah_torch import build_loop as ppo_loop

  cfg = Config()
  loop, eval_env = ppo_loop(cfg, halfcheetah_factory())
  eval_env.close()
  agent_state, time_step = loop.init(cfg.seed)
  draws = Draws(cfg.seed + 1, "cuda")
  for _ in range(HOST_PPO_WARMUP):
    agent_state, time_step, draws, info = loop.run_iteration(
        agent_state, time_step, draws)
  syncs, losses = [], []
  for _ in range(HOST_PPO_COUNTED):
    SYNC_SITES.clear()
    (time_step, experience), n = count_syncs(
        lambda: loop.collect(agent_state, time_step, draws))
    agent_state, info = loop.agent.train(agent_state, experience,
                                         draws=draws)
    syncs.append(n)
    losses.append(float(info.loss))
  ok = (all(math.isfinite(x) for x in losses)
        and agent_state.train_step == HOST_PPO_WARMUP + HOST_PPO_COUNTED
        and tuple(experience.step_type.shape) == (1, cfg.rollout_length)
        and experience.observation.device.type == "cuda")
  emit("host_ppo_main", card=card, env="RandomPyEnvironment x 1 "
       "(HalfCheetah-v5 specs)", batch_size=cfg.env_batch_size,
       rollout_length=cfg.rollout_length, epochs=cfg.num_epochs,
       minibatches=cfg.num_minibatches, fc=list(cfg.actor_fc_layers),
       counted_iterations=HOST_PPO_COUNTED, host_syncs_per_collect=syncs,
       host_sync_sites=dict(SYNC_SITES),
       host_syncs_per_env_step=[n / cfg.rollout_length for n in syncs],
       losses=losses, train_step=agent_state.train_step, ok=ok)
  loop.env.close()
  if not ok:
    fail("host_ppo_main", "host PPO checks failed")


def phase_parallel_env(card):
  """`ParallelPyEnvironment` of 4 workers started after CUDA is up: spawn,
  the same steps as a `BatchedPyEnvironment` of the same seeds, a clean
  close."""
  import functools

  import numpy as np
  import torch

  from agents_tpu_torch.environments.batched_py_environment import \
      BatchedPyEnvironment
  from agents_tpu_torch.environments.parallel_py_environment import \
      ParallelPyEnvironment
  from agents_tpu_torch.utils import nest_utils

  from agents_tpu_torch.environments.test_envs import RandomPyEnvironment

  cuda_up = torch.cuda.is_initialized()
  ctors = [functools.partial(RandomPyEnvironment, *halfcheetah_specs(),
                             episode_end_probability=0.05, seed=seed)
           for seed in range(PARALLEL_WORKERS)]
  results = {}
  for blocking in (False, True):
    penv = ParallelPyEnvironment(ctors, blocking=blocking)
    benv = BatchedPyEnvironment([c() for c in ctors])
    rng, equal = np.random.RandomState(0), True
    try:
      pairs = [(penv.reset(), benv.reset())]
      for _ in range(PARALLEL_STEPS):
        action = rng.uniform(-1, 1, (PARALLEL_WORKERS, HALFCHEETAH_ACT)
                             ).astype(np.float32)
        pairs.append((penv.step(action), benv.step(action)))
      for p, b in pairs:
        equal &= all(np.array_equal(x, y) for x, y in zip(
            nest_utils.flatten(p), nest_utils.flatten(b)))
      methods = penv.start_methods
    finally:
      penv.close()
      benv.close()
    results["blocking" if blocking else "overlapped"] = {
        "start_methods": methods, "steps_equal": bool(equal),
        "workers_alive_after_close": penv.workers_alive}
  ok = cuda_up and all(r["start_methods"] == ["spawn"] * PARALLEL_WORKERS
                       and r["steps_equal"]
                       and r["workers_alive_after_close"] == 0
                       for r in results.values())
  emit("parallel_env", card=card, workers=PARALLEL_WORKERS,
       steps=PARALLEL_STEPS, cuda_initialized=cuda_up, **results, ok=ok)
  if not ok:
    fail("parallel_env", f"parallel env checks failed: {results}")


def phase_async_resume(card):
  """The async loop with periodic and final checkpoints, then a fresh loop
  resumed toward a higher target (`tests/test_checkpoint_resume.py:
  100-160`): the restored state `torch.equal` to the saved one."""
  from agents_tpu_torch.train import Checkpointer
  from agents_tpu_torch.train.checkpointer import capture
  from examples.sac_halfcheetah_torch import build_loop as sac_loop

  cfg = sac_config(**ASYNC_RESUME)
  B = cfg.env_batch_size
  with tempfile.TemporaryDirectory() as tmp:
    ckpt = Checkpointer(tmp, max_to_keep=2)
    loop, eval_env = sac_loop(cfg, halfcheetah_factory(
        episode_end_probability=0.05))
    eval_env.close()
    kw = dict(seed=0, initial_random_steps=cfg.initial_collect_ticks,
              checkpointer=ckpt, checkpoint_interval_ticks=ASYNC_RESUME_EVERY)
    first = loop.run(total_env_batch_steps=ASYNC_RESUME_TICKS, **kw)
    saved = capture(loop._checkpoint_state(ASYNC_RESUME_TICKS))
    steps = ckpt.all_steps()
    loop.env.close()
    loop2, eval_env = sac_loop(cfg, halfcheetah_factory(
        episode_end_probability=0.05))
    eval_env.close()
    restored = capture(ckpt.restore(loop2.template_state(seed=7)))
    mismatched = nest_mismatches(saved, restored)
    second = loop2.run(total_env_batch_steps=ASYNC_RESUME_MORE, resume=True,
                       **kw)
    loop2.env.close()
  checks = {
      "checkpoints_kept": steps == [50, ASYNC_RESUME_TICKS],
      "restored_equal": not mismatched,
      "first_env_steps": first["env_steps"] == ASYNC_RESUME_TICKS * B,
      "resumed_env_steps": second["env_steps"] == ASYNC_RESUME_MORE * B,
      "train_steps_carried": second["train_steps"] >= first["train_steps"]
                             > 0,
      # More non-boundary frames than the resumed session alone steps.
      "metrics_carried": second["metrics"]["EnvironmentSteps"]
                         > max(first["metrics"]["EnvironmentSteps"],
                               (ASYNC_RESUME_MORE - ASYNC_RESUME_TICKS) * B),
      "drained": first["trainer_drained"] and second["trainer_drained"]}
  ok = all(checks.values())
  emit("async_resume", card=card, batch_size=B,
       ticks=[ASYNC_RESUME_TICKS, ASYNC_RESUME_MORE],
       checkpoint_interval_ticks=ASYNC_RESUME_EVERY, checkpoints=steps,
       criterion="torch.equal of every tensor, number and generator state",
       state_mismatched=mismatched[:10], train_steps=[
           first["train_steps"], second["train_steps"]],
       env_steps=[first["env_steps"], second["env_steps"]], checks=checks,
       ok=ok)
  if not ok:
    fail("async_resume", f"async resume checks failed: {checks}")


def host_phases(card):
  """The host environments and the three host-device loops; the parallel
  env's phase (`phase_parallel_env`) is in `UNTIMED_PHASES`."""
  phase_host_parity(card)
  phase_host_sac_main(card)
  free_card()
  phase_async_sac_main(card)
  free_card()
  phase_host_ppo_main(card)
  phase_async_resume(card)
  free_card()


# -- the host examples: Atari DQN and the offline CQL-SAC pipeline -------------

# `examples/dqn_atari_torch.py` at its Config (B=8, the 1M-frame ring, mnih15
# + fc 512 in fp32, sample 32, 8 train steps per call, UTD 0.25) with the
# run cut to 1,000 ticks over random envs with the Atari specs.
ATARI_HOST = dict(total_env_steps=8_000, initial_collect_ticks=500,
                  progress_every_ticks=1000)
ATARI_EPISODE_STEPS = 500
ATARI_EXPORT_ROWS = 256
# `examples/cql_sac_offline_host_torch.py` at its Config (B=32, actor
# (256, 256), critic (256, 256, 256), sample 256, 10 CQL samples, alpha
# 5.0, 64 train steps per call, 10 eval envs), the "mixed" dataset, with
# each phase cut.
OFFLINE_HOST = dict(behavior_env_steps=16_384, dataset_frames=16_384,
                    num_bc_steps=96, offline_train_steps=192,
                    eval_interval=128, dataset_mix="mixed")
OFFLINE_EXPORT_ROWS = 256
OFFLINE_EXPORT_RTOL, OFFLINE_EXPORT_ATOL = 1e-5, 1e-5
# Where `AsyncHostDeviceTrainLoop.run`, at its start, copies the initial
# networks to the host (`capture`): one sync per tensor of a fresh agent
# state, and no other main-thread sync of the run but the action reads.
RUN_START_SYNC_FILE = "checkpointer.py"


@contextlib.contextmanager
def wrapped(owner, name, wrap):
  """Within it, `owner.name` is `wrap(the original)`; restored after."""
  original = getattr(owner, name)
  setattr(owner, name, wrap(original))
  try:
    yield
  finally:
    setattr(owner, name, original)


def tensor_leaves(nest):
  """The number of tensors in a nest of dicts, lists and tuples."""
  import torch

  if isinstance(nest, torch.Tensor):
    return 1
  if isinstance(nest, dict):
    nest = list(nest.values())
  if isinstance(nest, (list, tuple)):
    return sum(tensor_leaves(v) for v in nest)
  return 0


@contextlib.contextmanager
def recorded_losses(*agent_classes):
  """Within it, each `train` of the agent classes keeps its loss tensor
  (unread) in ``{class name: [loss, ...]}``; the classes are restored
  after."""
  losses = {cls.__name__: [] for cls in agent_classes}
  originals = {cls: cls.train for cls in agent_classes}

  def wrap(cls, train):
    def recorded(self, agent_state, experience, *args, **kwargs):
      agent_state, info = train(self, agent_state, experience, *args,
                                **kwargs)
      losses[cls.__name__].append(info.loss.detach())
      return agent_state, info
    return recorded

  for cls, train in originals.items():
    cls.train = wrap(cls, train)
  try:
    yield losses
  finally:
    for cls, train in originals.items():
      cls.train = train


def all_finite(tensors):
  import torch
  return bool(tensors) and bool(torch.isfinite(torch.stack(tensors)).all())


def first_step(observation):
  """A batch of FIRST time steps over `observation`, on its device."""
  import torch

  from agents_tpu_torch.trajectories import time_step as ts

  b, device = observation.shape[0], observation.device
  return ts.TimeStep(step_type=torch.zeros(b, dtype=torch.int32,
                                           device=device),
                     reward=torch.zeros(b, device=device),
                     discount=torch.ones(b, device=device),
                     observation=observation)


def random_atari(seed):
  """A seeded `RandomPyEnvironment` with the specs of the repaired
  `suites.load_atari` (observation [84, 84, 4] uint8, Pong's 6 actions)
  and 500-step episodes."""
  from agents_tpu_torch.environments.test_envs import RandomPyEnvironment
  from examples.dqn_atari_torch import atari_specs

  return RandomPyEnvironment(*atari_specs(), episode_end_probability=0.0,
                             max_duration=ATARI_EPISODE_STEPS, seed=seed)


def phase_atari_host(card):
  """`examples/dqn_atari_torch.py`'s `train_eval` at its full width, the
  1M-frame uint8 ring on the card, over random Atari-spec envs."""
  import numpy as np
  import torch

  from agents_tpu_torch.agents.dqn import DqnAgent
  from agents_tpu_torch.policies.policy_saver import load_manifest
  from agents_tpu_torch.train.checkpointer import capture
  from examples import dqn_atari_torch as ex

  free_card()
  torch.cuda.reset_peak_memory_stats()
  os.makedirs(RUNS_DIR, exist_ok=True)
  root = tempfile.mkdtemp(prefix="atari_host_", dir=RUNS_DIR)
  cfg = ex.Config(root_dir=root, **ATARI_HOST)
  B, K = cfg.env_batch_size, cfg.train_steps_per_call
  seeds = iter(range(10**6))
  syncs, built = {}, {}

  def recording(build_loop):
    # The example's loop with the syncs of its `run` recorded (the export
    # after the run syncs by design), and the tensors of a fresh agent
    # state counted: the run copies those to the host at its start.
    def build(*args, **kwargs):
      loop = build_loop(*args, **kwargs)
      built.update(loop=loop,
                   initial_tensors=tensor_leaves(capture(loop.agent.init())))
      run = loop.run

      def recorded_run(*a, **k):
        with recorded_syncs(syncs):
          return run(*a, **k)
      loop.run = recorded_run
      return loop
    return build

  with recorded_losses(DqnAgent) as losses, \
      wrapped(ex, "build_loop", recording):
    out = ex.train_eval(cfg, make_env=lambda: random_atari(next(seeds)))
  loop = built["loop"]
  losses = losses["DqnAgent"]
  ticks = cfg.total_env_steps // B
  min_frames = cfg.initial_collect_ticks * B
  policy_ticks = ticks - cfg.initial_collect_ticks
  main_syncs = syncs.get("MainThread", {})
  action_reads = sum(n for s, n in main_syncs.items()
                     if "jitted_py_policy.py" in s)
  run_start = {s: n for s, n in main_syncs.items()
               if RUN_START_SYNC_FILE in s}
  collector_other = {s: n for s, n in main_syncs.items()
                     if "jitted_py_policy.py" not in s
                     and RUN_START_SYNC_FILE not in s}
  trainer_syncs = {t: n for t, n in syncs.items() if t != "MainThread"}
  state, agent = out["agent_state"], loop.agent
  epsilon = agent.collect_policy._epsilon(agent.collect_policy_params(state))
  obs = loop._replay_state.storage.observation
  ring_bytes = obs.numel() * obs.element_size()

  # The exported greedy program against the live greedy policy, on the
  # frames of the ring's first ticks.
  frames = obs[:ATARI_EXPORT_ROWS // B].reshape(
      (ATARI_EXPORT_ROWS,) + tuple(obs.shape[2:]))
  actions, report = artifact_actions(
      "atari_host", out["policy_dir"], frames.cpu().numpy(), root)
  with torch.no_grad():
    live = agent.policy.action(state.q_network,
                               first_step(frames)).action.cpu().numpy()
    q = state.q_network(frames)[0].cpu().numpy()
  top2 = np.sort(q, axis=-1)[:, -2:]
  clear = (top2[:, 1] - top2[:, 0]) > EXPORT_TIE
  differ = {p: int((a.reshape(-1)[clear] != live[clear]).sum())
            for p, a in actions.items()}
  manifest = load_manifest(out["policy_dir"])
  checks = {
      "trainer_drained": out["trainer_drained"],
      "env_steps_exact": out["env_steps"] == ticks * B,
      "train_steps_within_utd": 0 < out["train_steps"]
                                <= cfg.utd_ratio * (out["env_steps"]
                                                    - min_frames) + K,
      "every_train_step_recorded": len(losses) == out["train_steps"]
                                   == state.train_step,
      "losses_finite": all_finite(losses),
      "epsilon_schedule": epsilon == ex.epsilon_fn(cfg)(state.train_step),
      "one_sync_per_policy_tick": action_reads == policy_ticks,
      "run_start_sync_per_initial_tensor": sum(run_start.values())
                                           == built["initial_tensors"],
      "no_other_collector_sync": not collector_other,
      "ring_on_card_uint8": (obs.device.type == "cuda"
                             and obs.dtype == torch.uint8
                             and ring_bytes
                             == cfg.replay_capacity_frames * 84 * 84 * 4),
      "export_batch_polymorphic": manifest["torch_export"]
                                  == "batch-polymorphic",
      "export_acts_as_live": not any(differ.values())
                             and not report["leaked"],
      "train_jsonl_written": os.path.exists(os.path.join(root,
                                                         "train.jsonl"))}
  ok = all(checks.values())
  emit("atari_host", card=card,
       env=f"RandomPyEnvironment x {B} (load_atari specs: (84, 84, 4) "
       "uint8, 6 actions)", batch_size=B,
       replay_capacity_frames=cfg.replay_capacity_frames,
       ring_per_row=cfg.replay_capacity_frames // B,
       ring_observation_bytes=ring_bytes, conv=cfg.conv_layer_params,
       fc=cfg.fc_layer_params, dtype="float32",
       sample_batch_size=cfg.sample_batch_size, train_steps_per_call=K,
       utd_ratio=cfg.utd_ratio, adam_epsilon=cfg.adam_epsilon,
       cuts=["ALE -> RandomPyEnvironment with the repaired load_atari specs "
             f"(Pong's 6 actions, {ATARI_EPISODE_STEPS}-step episodes)",
             f"total_env_steps 12,500,000 -> {cfg.total_env_steps}",
             f"initial_collect_ticks 2,500 -> {cfg.initial_collect_ticks}",
             f"progress_every_ticks 2,000 -> {cfg.progress_every_ticks}"],
       env_steps=out["env_steps"], train_steps=out["train_steps"],
       ticks_trainer_idle=out["ticks_trainer_idle"],
       ticks_trainer_busy=out["ticks_trainer_busy"],
       last_loss=out["last_loss"], epsilon_at_last_step=epsilon,
       action_read_syncs=action_reads, policy_ticks=policy_ticks,
       collector_other_syncs=collector_other, run_start_syncs=run_start,
       initial_state_tensors=built["initial_tensors"],
       trainer_thread_syncs=trainer_syncs, main_thread_syncs=main_syncs,
       export_rows=ATARI_EXPORT_ROWS, rows_clear_of_ties=int(clear.sum()),
       tie=EXPORT_TIE, actions_differing_from_live=differ,
       export=manifest["torch_export"],
       child_modules_leaked=report["leaked"],
       peak_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
       checks=checks, ok=ok)
  if not ok:
    fail("atari_host", f"Atari host checks failed: {checks}")


def collect_frames_on_disk(data_dir, data_spec, collects):
  """(the non-boundary frames of each collect in the dataset on disk, the
  dataset's frames per row); the collects lie in order, `ticks` frames
  of [B, ...] each."""
  import numpy as np

  from agents_tpu_torch.utils import dataset_io

  step_types = np.concatenate([
      np.asarray(shard.step_type) for shard in
      dataset_io.load_trajectory_dataset(data_dir, data_spec)])
  out, start = [], 0
  for c in collects:
    part = step_types[start:start + c["ticks"]]
    out.append(int((part != 2).sum()))       # StepType.LAST: a boundary
    start += c["ticks"]
  return out, int(step_types.shape[0])


def phase_offline_host(card):
  """`examples/cql_sac_offline_host_torch.py`'s `train_eval` ("mixed") at
  its full width over random HalfCheetah-spec envs, then phase C again
  through `reuse_phase_ab` from its root."""
  import numpy as np
  import torch

  from agents_tpu_torch.agents.cql import CqlSacAgent
  from agents_tpu_torch.agents.sac import SacAgent
  from agents_tpu_torch.eval import metric_utils
  from agents_tpu_torch.metrics import py_metrics
  from agents_tpu_torch.policies.jitted_py_policy import JittedPyPolicy
  from agents_tpu_torch.trajectories import time_step as ts
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils import dataset_io
  from examples import cql_sac_offline_host_torch as ex

  free_card()
  os.makedirs(RUNS_DIR, exist_ok=True)
  base = tempfile.mkdtemp(prefix="offline_host_", dir=RUNS_DIR)
  cfg = ex.Config(root_dir=os.path.join(base, "first"), **OFFLINE_HOST)
  reuse = dataclasses.replace(cfg, root_dir=os.path.join(base, "reuse"),
                              reuse_phase_ab=cfg.root_dir)
  B = cfg.env_batch_size
  runs = {}
  for name, c in (("first", cfg), ("reuse", reuse)):
    stats, chunk_syncs, live = {}, {}, {}

    def recording(train_chunk):
      # Each phase-C train call with its syncs recorded; the agent and the
      # state of the last one are the live policy that phase C exports.
      def chunk(cfg_, agent, agent_state, *args):
        with recorded_syncs(chunk_syncs):
          agent_state, loss = train_chunk(cfg_, agent, agent_state, *args)
        live.update(agent=agent, state=agent_state)
        return agent_state, loss
      return chunk

    with recorded_losses(SacAgent, CqlSacAgent) as losses, \
        wrapped(ex, "train_chunk", recording):
      result = ex.train_eval(c, make_env=halfcheetah_factory(), stats=stats)
    runs[name] = dict(result=result, stats=stats, chunk_syncs=chunk_syncs,
                      live=live, losses=losses)
  first, again = runs["first"], runs["reuse"]
  a, b_, c_ = (first["stats"]["phase_a"], first["stats"]["phase_b"],
               first["stats"]["phase_c"])

  # The dataset on disk and both rings hold the frames collected.
  obs_spec, act_spec = halfcheetah_specs()
  data_spec = tj.trajectory_spec(ts.time_step_spec(obs_spec), act_spec)
  data_dir = os.path.join(cfg.root_dir, "dataset")
  per_collect, rows_frames = collect_frames_on_disk(data_dir, data_spec,
                                                    b_["collects"])
  ticks = sum(col["ticks"] for col in b_["collects"])
  counts_ok = (rows_frames == ticks == dataset_io.dataset_num_frames(data_dir)
               == c_["ring_count"] == again["stats"]["phase_c"]["ring_count"]
               and all(col["frames"] <= n < col["frames"] + B
                       for col, n in zip(b_["collects"], per_collect)))

  # Phase C again from the same dataset and seed: the same losses at every
  # step and the same final parameters, bit for bit.
  cql_first, cql_again = (first["losses"]["CqlSacAgent"],
                          again["losses"]["CqlSacAgent"])
  losses_equal = len(cql_first) == len(cql_again) == \
      cfg.offline_train_steps and all(
          torch.equal(x, y) for x, y in zip(cql_first, cql_again))
  greedy = {n: os.path.join(c.root_dir, "policies", "greedy_policy")
            for n, c in (("first", cfg), ("reuse", reuse))}
  saved = {n: torch.load(os.path.join(d, "params.pt"), weights_only=True)
           for n, d in greedy.items()}
  params_equal = sorted(saved["first"]) == sorted(saved["reuse"]) and all(
      torch.equal(saved["first"][k], saved["reuse"][k])
      for k in saved["first"])

  # The exported greedy program against the live greedy policy (the
  # agent's state after its last train call), in a bare process, on
  # random observations.
  agent = first["live"]["agent"]
  live_params = agent.policy_params(first["live"]["state"])
  obs = np.random.RandomState(3).randn(OFFLINE_EXPORT_ROWS,
                                       HALFCHEETAH_OBS).astype(np.float32)
  actions, report = artifact_actions(
      "offline_host", greedy["first"], obs, base)
  with torch.no_grad():
    live = agent.policy.action(live_params, first_step(
        torch.from_numpy(obs).cuda())).action.cpu().numpy()
  export_diff = {p: float(np.max(np.abs(x - live))) for p, x in
                 actions.items()}
  export_ok = all(np.allclose(x, live, rtol=OFFLINE_EXPORT_RTOL,
                              atol=OFFLINE_EXPORT_ATOL)
                  for x in actions.values()) and not report["leaked"]

  # A greedy eval of the live policy counts exactly the episodes asked.
  eval_env = ex.build_env(cfg, make_env=halfcheetah_factory())[1]
  counted = metric_utils.compute(
      [py_metrics.AverageReturnMetric(cfg.num_eval_episodes),
       py_metrics.NumberOfEpisodes()], eval_env,
      JittedPyPolicy(agent.policy, live_params),
      num_episodes=cfg.num_eval_episodes)
  eval_env.close()
  evals = [json.loads(line) for line in open(
      os.path.join(cfg.root_dir, "offline.jsonl"))]
  eval_losses = [r["cql_loss"] for r in evals if "cql_loss" in r]
  checks = {
      "frames_on_disk_and_in_rings": counts_ok,
      "behavior_losses_finite": all_finite(first["losses"]["SacAgent"]),
      "behavior_trained": a["train_steps"] > 0 and a["trainer_drained"],
      "cql_losses_finite": all_finite(cql_first + cql_again),
      "snapshots": len(a["snapshot_env_steps"]) == 3,
      "reuse_losses_bit_for_bit": losses_equal,
      "reuse_params_bit_for_bit": params_equal,
      "no_sync_in_phase_c_train_calls": not first["chunk_syncs"]
                                        and not again["chunk_syncs"],
      "eval_episodes_exact": int(counted["NumberOfEpisodes"])
                             == cfg.num_eval_episodes,
      "eval_losses_read": len(eval_losses) == sum(
          1 for step in range(cfg.train_steps_per_call,
                              cfg.offline_train_steps + 1,
                              cfg.train_steps_per_call)
          if step % cfg.eval_interval < cfg.train_steps_per_call) and all(
          math.isfinite(x) for x in eval_losses),
      "result_keys": sorted(first["result"]) == sorted(again["result"]),
      "export_acts_as_live": export_ok}
  ok = all(checks.values())
  emit("offline_host", card=card,
       env=f"random_halfcheetah x {B} (HalfCheetah-v5 specs, 1,000-step "
       "episodes)", batch_size=B, actor=list(cfg.actor_fc_layers),
       critic=list(cfg.critic_joint_fc_layers),
       sample_batch_size=cfg.offline_batch_size,
       num_cql_samples=cfg.num_cql_samples, cql_alpha=cfg.cql_alpha,
       train_steps_per_call=cfg.train_steps_per_call,
       num_eval_envs=cfg.num_eval_envs, dataset_mix=cfg.dataset_mix,
       cuts=["HalfCheetah-v5 -> chip_smoke.random_halfcheetah (no MuJoCo on "
             "the card's machine)"] + [
                 f"{k} {getattr(ex.Config(), k)} -> {v}"
                 for k, v in OFFLINE_HOST.items() if k != "dataset_mix"],
       phase_a={"env_steps": a["env_steps"], "train_steps": a["train_steps"],
                "snapshot_env_steps": a["snapshot_env_steps"]},
       phase_b={"collects": b_["collects"],
                "non_boundary_frames_per_collect": per_collect,
                "frames_per_row_on_disk": rows_frames},
       phase_c={"train_steps": c_["train_steps"],
                "ring_count": c_["ring_count"]},
       eval_losses=eval_losses, result=first["result"],
       reuse_result=again["result"],
       export_max_abs_diff=export_diff, export_rows=OFFLINE_EXPORT_ROWS,
       child_modules_leaked=report["leaked"],
       counted_eval_episodes=int(counted["NumberOfEpisodes"]),
       checks=checks, ok=ok)
  if not ok:
    fail("offline_host", f"offline host checks failed: {checks}")


def host_example_phases(card):
  """The Atari DQN and offline CQL-SAC host examples."""
  phase_atari_host(card)
  free_card()
  phase_offline_host(card)
  free_card()


# -- prioritized replay, the other buffers and distributed SAC -----------------

PER_ALPHA, PER_BETA = 0.6, 0.4
PER_PARITY = dict(capacity=64, sample_batch_size=32, fc=(100, 50))
PER_PARITY_INITIAL, PER_PARITY_STEPS, PER_PARITY_MIN_COMPARED = 16, 5, 3
# A sample is clear of a CDF boundary when its uniform lies more than this
# many ulps of the total from the CDF entries around it (the gap rule).
PER_GAP_ULPS = 4
# `per_main`'s sync-checked stretch: two periods of the target update.
PER_INITIAL, PER_WARMUP, PER_CHECKED = 100, 20, 10
# `tests/test_prioritized_replay.py:165-204`'s config; its bar is the JAX
# test's 100, which the JAX package's own runs over seeds 0-4 (117.2 to
# 200.0) do not tighten (`tests/test_torch_reference_bars.py`, `per_bar`).
PER_LEARN = dict(batch_size=32, capacity=256, sample_batch_size=64,
                 fc=(64, 64))
PER_LEARN_INITIAL, PER_LEARN_ITERATIONS, PER_LEARN_CHUNK = 64, 1600, 400
PER_LEARN_GATE = 100.0
EPISODIC = dict(batch_size=64, num_slots=256, max_episode_len=64)
EPISODIC_CALLS, EPISODIC_DRAIN_EVERY, EPISODIC_SAMPLE = 300, 50, 256
INGEST_LEG_STEPS, INGEST_RATIO, INGEST_COLLECTORS = 400, 8.0, 2
INGEST_ENV_BATCH = 8
# A collector's rewards tag each frame: collector * 2**22 + env * 2**17 +
# the env's count of time steps, exact in float32.
INGEST_COLLECTOR_TAG, INGEST_ENV_TAG = 1 << 22, 1 << 17
# `bench.py:host_atari_replay_probe`'s 1M frames (28 GB) cut to 100k
# (2.8 GB of host RAM); its hashed variant's 100k frames.
HOST_REPLAY_CAPACITY = HOST_REPLAY_HASHED = 100_000


def build_per_loop(device, batch_size, capacity, sample_batch_size, fc):
  """`build_loop`'s DQN loop with its replay made prioritized (alpha 0.6,
  beta 0.4)."""
  from agents_tpu_torch.replay_buffers import PrioritizedReplay
  from agents_tpu_torch.train import FusedTrainLoop

  loop = build_loop(device, batch_size, capacity, sample_batch_size, fc)
  replay = PrioritizedReplay(loop.replay.data_spec, batch_size, capacity,
                             alpha=PER_ALPHA, device=device)
  return FusedTrainLoop(loop.env, loop.agent, replay, metrics=loop.metrics,
                        sample_batch_size=sample_batch_size,
                        per_beta=PER_BETA, device=device)


def record_per_samples(loop):
  """Wraps `loop.replay.sample` to keep, per call, the priorities and count
  it sampled from and its info; returns the list."""
  samples, sample = [], loop.replay.sample

  def recorded(state, draws, *args, **kwargs):
    batch, info = sample(state, draws, *args, **kwargs)
    samples.append((state.priorities.clone(), state.count, info))
    return batch, info

  loop.replay.sample = recorded
  return samples


def per_clear_of_boundaries(replay, priorities, count, num_steps, u):
  """On the CPU: whether each stratified uniform `u` ([S] in [0, 1)) lies
  more than `PER_GAP_ULPS` ulps of the total from the CDF entries around
  it, for a sample of `priorities` at `count`."""
  import numpy as np
  import torch

  from agents_tpu_torch.replay_buffers.prioritized_replay import \
      chunked_cumsum

  size = min(count, replay.capacity)
  t_r = replay._time_ids(count).cpu()
  valid = (t_r >= 0) & (t_r >= count - size) & (t_r <= count - num_steps)
  flat = torch.where(valid[:, None], torch.pow(priorities.cpu(), replay.alpha),
                     0.0).reshape(-1)
  cdf = chunked_cumsum(flat).numpy()
  total = np.float32(max(cdf[-1], 1e-30))
  s = len(u)
  x = (np.arange(s, dtype=np.float32) + np.asarray(u, np.float32)) \
      / np.float32(s) * total
  x = np.minimum(x, total * np.float32(1.0 - 1e-7))
  idx = np.searchsorted(cdf, x, side="right")
  lo = np.where(idx > 0, cdf[np.maximum(idx - 1, 0)], -np.inf)
  hi = cdf[np.minimum(idx, len(cdf) - 1)]
  gap = PER_GAP_ULPS * np.spacing(total)
  return (x - lo > gap) & (hi - x > gap)


def phase_per_parity(card):
  """The PER fused DQN loop (B=64, ring 64, sample 32, (100, 50), alpha 0.6,
  beta 0.4, TF32 off), card against CPU, each iteration started from the
  CPU's state with the CPU's draws: ids and rows equal on every sample
  clear of a CDF boundary; on an iteration whose samples all agree, the
  sample's probabilities and IS weights, the loss, the priorities, the max
  priority and the networks at rtol 1e-5 / atol 1e-6."""
  import copy

  import numpy as np
  import torch

  from agents_tpu_torch.train.checkpointer import capture, restore_into
  from agents_tpu_torch.utils import convert
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  state_dict = convert.q_params_to_state_dict(
      numpy_q_params(np.random.RandomState(0), PER_PARITY["fc"]))
  loops = {d: build_per_loop(d, B_PARITY, **PER_PARITY)
           for d in ("cpu", "cuda")}
  samples = {}
  for device, loop in loops.items():
    loop.agent.q_network.load_state_dict(state_dict)
    samples[device] = record_per_samples(loop)
  draws = RecordingDraws(Draws(0, "cpu"))
  cstate = loops["cpu"].init(draws=draws,
                             initial_collect_steps=PER_PARITY_INITIAL)
  gstate = loops["cuda"].init(seed=0)
  diffs, mismatched, compared, flipped, clear_total = {}, [], 0, [], 0

  def compare(tag, card_value, cpu_value):
    a, b = card_value.detach().cpu(), cpu_value.detach().cpu()
    if a.dtype.is_floating_point:
      diffs[tag] = max_diff(a, b)
      if not torch.allclose(a, b, rtol=RTOL, atol=ATOL):
        mismatched.append(tag)
    elif not torch.equal(a, b):
      mismatched.append(tag)

  for step in range(PER_PARITY_STEPS):
    # A copy of the CPU's state: `capture` shares a CPU tensor, and an
    # optimizer's `load_state_dict` keeps a tensor already on its device.
    for field in ("driver_state", "replay_state", "agent_state",
                  "metric_states"):
      gstate = dataclasses.replace(gstate, **{field: restore_into(
          getattr(gstate, field),
          copy.deepcopy(capture(getattr(cstate, field))))})
    seen = record_counts(draws)
    cstate, cinfo = loops["cpu"].iteration(cstate)
    gstate = dataclasses.replace(gstate, draws=ReplayDraws(
        new_records(draws, seen), "cuda"))
    gstate, ginfo = loops["cuda"].iteration(gstate)
    (cprio, count, cs), (gprio, _, gs) = samples["cpu"][-1], samples["cuda"][-1]
    clear = torch.from_numpy(per_clear_of_boundaries(
        loops["cpu"].replay, cprio, count, 2, draws.records["per_u"][-1]))
    clear_total += int(clear.sum())
    for name in ("ids", "rows"):
      compare(f"step{step}.{name}.clear", getattr(gs, name).cpu()[clear],
              getattr(cs, name)[clear])
    if not (torch.equal(gs.ids.cpu(), cs.ids)
            and torch.equal(gs.rows.cpu(), cs.rows)):
      flipped.append(step)     # a near-tie the gap rule allows to differ
      continue
    compared += 1
    compare(f"step{step}.priorities_sampled", gprio, cprio)
    compare(f"step{step}.probabilities", gs.probabilities, cs.probabilities)
    compare(f"step{step}.is_weights", gs.is_weights, cs.is_weights)
    compare(f"step{step}.loss", ginfo.loss, cinfo.loss)
    compare(f"step{step}.priorities", gstate.replay_state.priorities,
            cstate.replay_state.priorities)
    compare(f"step{step}.max_priority", gstate.replay_state.max_priority,
            cstate.replay_state.max_priority)
    gtensors, ctensors = (dqn_tensors(gstate.agent_state),
                          dqn_tensors(cstate.agent_state))
    for k in ctensors:
      compare(f"step{step}.{k}", gtensors[k], ctensors[k])
  samples_total = PER_PARITY_STEPS * PER_PARITY["sample_batch_size"]
  ok = not mismatched and compared >= PER_PARITY_MIN_COMPARED
  worst = max(diffs, key=diffs.get)
  emit("per_parity", card=card, batch_size=B_PARITY, **{
      k: list(v) if isinstance(v, tuple) else v for k, v in PER_PARITY.items()},
       alpha=PER_ALPHA, beta=PER_BETA, steps=PER_PARITY_STEPS, rtol=RTOL,
       atol=ATOL, gap_ulps=PER_GAP_ULPS, samples=samples_total,
       samples_clear=clear_total, steps_compared=compared,
       steps_with_a_permitted_flip=flipped,
       largest_float_diff={"name": worst, "abs": diffs[worst]},
       mismatched=mismatched, ok=ok)
  if not ok:
    fail("per_parity", f"card and CPU disagree on {mismatched[:10]}, or "
         f"fewer than {PER_PARITY_MIN_COMPARED} steps compared ({compared})")


def phase_per_main(card):
  """PER at the CartPole bench point (B=4096, ring 512: 2,097,152
  priorities, 8 MiB; sample 256; (100, 50)): a sync-checked stretch, the
  replay count, finite losses, IS weights in (0, 1] and spread
  priorities."""
  import torch

  from agents_tpu_torch.utils.draws import Draws

  loop = build_per_loop("cuda", B_MAIN, **MAIN)
  state = loop.init(seed=0, initial_collect_steps=PER_INITIAL)
  state, _ = loop.run(state, PER_WARMUP)
  state, losses = sync_checked(loop.run, state, PER_CHECKED)
  replay, rstate = loop.replay, state.replay_state
  count_ok = rstate.count == PER_INITIAL + PER_WARMUP + PER_CHECKED
  finite = bool(torch.isfinite(losses).all())
  _, info = replay.sample(rstate, Draws(1, "cuda"), MAIN["sample_batch_size"],
                          num_steps=2, beta=PER_BETA)
  w = info.is_weights
  weights_ok = bool(((w > 0) & (w <= 1)).all())
  priorities = rstate.priorities
  priorities_ok = bool(torch.isfinite(priorities).all()) and float(
      priorities.std()) > 0.0
  ok = count_ok and finite and weights_ok and priorities_ok
  emit("per_main", card=card, batch_size=B_MAIN, **{
      k: list(v) if isinstance(v, tuple) else v for k, v in MAIN.items()},
       alpha=PER_ALPHA, beta=PER_BETA, priorities=priorities.numel(),
       priority_bytes=priorities.numel() * priorities.element_size(),
       checked_iterations=PER_CHECKED, sync_debug_mode="error",
       replay_count=rstate.count, replay_count_exact=count_ok,
       losses_finite=finite, is_weights_in_0_1=weights_ok,
       is_weights_min=float(w.min()),
       priorities_finite_and_spread=priorities_ok, ok=ok)
  if not ok:
    fail("per_main", "PER checks failed (replay count, losses, IS weights "
         "or priorities)")


def phase_per_learn(card):
  """`tests/test_prioritized_replay.py:165-204`'s PER loop to 1,600
  iterations: the last-20 return above its bar, priorities spread, then
  greedy eval over exactly 30 episodes."""
  import torch

  loop = build_per_loop("cuda", **PER_LEARN)
  state = loop.init(seed=0, initial_collect_steps=PER_LEARN_INITIAL)
  iterations, points = 0, []
  while iterations < PER_LEARN_ITERATIONS:
    state, losses = loop.run(state, PER_LEARN_CHUNK)
    iterations += PER_LEARN_CHUNK
    points.append([iterations,
                   float(loop.results(state)["AverageReturn"])])
  ret = points[-1][1]
  std = float(state.replay_state.priorities.std())
  out = loop.evaluate(state, 101, num_episodes=30, max_steps=2000)
  episodes = int(out["NumberOfEpisodes"])
  finite = bool(torch.isfinite(losses).all())
  ok = ret > PER_LEARN_GATE and std > 0.0 and finite and episodes == 30
  emit("per_learn", card=card, **{
      k: list(v) if isinstance(v, tuple) else v for k, v in PER_LEARN.items()},
       alpha=PER_ALPHA, beta=PER_BETA, iterations=iterations,
       last20_average_return=ret, gate=PER_LEARN_GATE, points=points,
       priority_std=std, losses_finite=finite, eval_episodes=episodes,
       eval_average_return=float(out["AverageReturn"]), ok=ok)
  if not ok:
    fail("per_learn", f"last-20 return {ret} (gate > {PER_LEARN_GATE}), "
         f"priority std {std}, {episodes} eval episodes of 30")


def cartpole_frames(batch_size, steps, seed=0):
  """`steps` Trajectory frames of `batch_size` CartPole rows under random
  actions, on the CPU."""
  from agents_tpu_torch.environments import BatchedTorchEnv
  from agents_tpu_torch.environments.classic import CartPole
  from agents_tpu_torch.trajectories import policy_step
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils.draws import Draws

  env = BatchedTorchEnv(CartPole(), batch_size, device="cpu")
  draws = Draws(seed, "cpu")
  env_state, step = env.reset(draws)
  frames = []
  for _ in range(steps):
    action = draws.randint("random_action", (batch_size,), 0, 2)
    env_state, nxt = env.step(env_state, step, action, draws)
    frames.append(tj.from_transition(
        step, policy_step.PolicyStep(action=action), nxt))
    step = nxt
  return env, frames


def phase_episodic(card):
  """`EpisodicReplay` on CartPole rows (B=64) for 300 `add_batch` calls on
  "cpu" and "cuda" with the same frames: slots, lengths, ids, cursor and
  completed ids equal at every call; the card's calls and its
  `sample_episodes` (the CPU's draws replayed) make no host sync, the
  callback drains aside; the sampled episodes equal."""
  import torch

  from agents_tpu_torch.replay_buffers.episodic_replay import (
      CompletionCallback, EpisodicReplay)
  from agents_tpu_torch.trajectories import trajectory as tj
  from agents_tpu_torch.utils import nest_utils
  from agents_tpu_torch.utils.draws import Draws, RecordingDraws, ReplayDraws

  B = EPISODIC["batch_size"]
  env, frames = cartpole_frames(B, EPISODIC_CALLS)
  spec = tj.trajectory_spec(env.time_step_spec(), env.action_spec())
  fields = ("open_slot", "open_len", "lengths", "episode_ids", "next_slot",
            "next_episode_id", "num_completed")
  runs = {}
  for device in ("cpu", "cuda"):
    replay = EpisodicReplay(spec, device=device, **EPISODIC)
    device_frames = [to_device(f, device) for f in frames]
    fired = []
    callback = CompletionCallback([fired.append])
    state, trace, pending = replay.init(), [], []
    if device == "cpu":
      draws = RecordingDraws(Draws(5, "cpu"))
    else:     # the CPU's draws, copied to the card before the checked calls
      draws = ReplayDraws(runs["cpu"]["draws"].records, "cuda")
    if device == "cuda":
      torch.cuda.synchronize()
      torch.cuda.set_sync_debug_mode("error")
    for i, frame in enumerate(device_frames, start=1):
      state, done = replay.add_batch(state, frame, return_completed=True)
      pending.append(done)
      trace.append([getattr(state, f).clone() for f in fields] + [done])
      if i % EPISODIC_DRAIN_EVERY == 0:
        torch.cuda.set_sync_debug_mode(0)
        callback(torch.cat(pending))
        if device == "cuda":
          torch.cuda.set_sync_debug_mode("error")
        pending = []
    sampled = {completed_only: replay.sample_episodes(
        state, draws, EPISODIC_SAMPLE, completed_only=completed_only,
        return_info=True) for completed_only in (True, False)}
    torch.cuda.set_sync_debug_mode(0)
    runs[device] = dict(state=state, trace=trace, sampled=sampled,
                        fired=fired, draws=draws)
  mismatched = []
  for i, (ct, gt) in enumerate(zip(runs["cpu"]["trace"],
                                   runs["cuda"]["trace"])):
    for name, a, b in zip(fields + ("completed_ids",), gt, ct):
      if not torch.equal(a.cpu(), b):
        mismatched.append(f"call{i}.{name}")
  for completed_only in (True, False):
    g, c = runs["cuda"]["sampled"][completed_only], runs["cpu"]["sampled"][
        completed_only]
    for j, (a, b) in enumerate(zip(nest_utils.flatten(g),
                                   nest_utils.flatten(c), strict=True)):
      if not torch.equal(a.cpu(), b):
        mismatched.append(f"sample.{completed_only}.{j}")
  for j, (a, b) in enumerate(zip(
      nest_utils.flatten(runs["cuda"]["state"].storage),
      nest_utils.flatten(runs["cpu"]["state"].storage))):
    if not torch.equal(a.cpu(), b):
      mismatched.append(f"storage.{j}")
  gpu = runs["cuda"]
  completed = int(gpu["state"].num_completed)
  fired_ok = gpu["fired"] == runs["cpu"]["fired"] and len(
      gpu["fired"]) == completed
  wrapped = completed > EPISODIC["num_slots"]
  ok = not mismatched and fired_ok and wrapped
  emit("episodic", card=card, **EPISODIC,
       add_batch_calls=EPISODIC_CALLS, drain_every=EPISODIC_DRAIN_EVERY,
       sync_debug_mode="error outside the callback drains",
       completed_episodes=completed, slot_ring_wrapped=wrapped,
       callbacks_fired=len(gpu["fired"]), callbacks_equal=fired_ok,
       mismatched=mismatched[:10], ok=ok)
  if not ok:
    fail("episodic", f"card and CPU disagree on {mismatched[:10]}, "
         f"callbacks equal {fired_ok}, ring wrapped {wrapped}")


def pendulum_specs():
  """Pendulum-v1's observation (3,) in [-1, -1, -8]..[1, 1, 8] and action
  (1,) in [-2, 2]."""
  import numpy as np

  from agents_tpu_torch.specs import array_spec

  return (array_spec.BoundedArraySpec((3,), np.float32, [-1.0, -1.0, -8.0],
                                      [1.0, 1.0, 8.0]),
          array_spec.BoundedArraySpec((1,), np.float32, -2.0, 2.0))


def ingest_collector(ring, weights_shm, collector):
  """A collect job of `examples/sac_collect_job_torch.py` on the CPU (B=8)
  over `RandomPyEnvironment`s with Pendulum-v1's specs, each wrapped so
  that the reward of every time step it returns, resets included, tags it
  with the collector, the env and a running count; it runs until its
  learner's SIGTERM."""
  import itertools

  import numpy as np

  from agents_tpu_torch.environments.test_envs import RandomPyEnvironment
  from agents_tpu_torch.environments.wrappers import PyEnvironmentBaseWrapper
  from examples import sac_collect_job_torch as job

  class TaggedRewards(PyEnvironmentBaseWrapper):

    def __init__(self, env, base):
      super().__init__(env)
      self._base, self._count = base, 0

    def _tag(self, time_step):
      self._count += 1
      return dataclasses.replace(time_step, reward=np.asarray(
          self._base + self._count, np.float32))

    def _reset(self):
      return self._tag(self._env.reset())

    def _step(self, action):
      return self._tag(self._env.step(action))

  cid, envs = int(collector), itertools.count()

  def make_env(_):
    k = next(envs)
    return TaggedRewards(
        RandomPyEnvironment(*pendulum_specs(), seed=1000 * cid + k),
        cid * INGEST_COLLECTOR_TAG + k * INGEST_ENV_TAG)

  args = job.parse_args([f"--root_dir={RUNS_DIR}", f"--ring={ring}",
                         f"--env_batch_size={INGEST_ENV_BATCH}",
                         f"--weights_shm={weights_shm}", f"--seed={cid}"])
  job.run_collector(args, make_env=make_env,
                    log=lambda line: print(line, flush=True))


def check_ingested(blocks, pushed):
  """The drained [n, 2, ...] pairs against the collectors' reports: each
  pair's tags are one env's consecutive steps, no frame arrives twice,
  each collector's count is what it pushed, and a frame that arrives in
  two pairs (second of one, first of the next) has the same bytes in
  both. Returns a dict of counts and failures."""
  import numpy as np

  from agents_tpu_torch.utils import nest_utils

  firsts, seconds, counts, bad_pairs = {}, {}, {}, 0
  for block in blocks:
    leaves = [np.asarray(x) for x in nest_utils.flatten_sorted(block)]
    n = leaves[0].shape[0]
    halves = [np.concatenate([x[:, h].reshape(n, -1).view(np.uint8)
                              for x in leaves], axis=1) for h in (0, 1)]
    tags = block.reward.astype(np.int64)
    bad_pairs += int((tags[:, 1] != tags[:, 0] + 1).sum())
    for i in range(n):
      t0, t1 = int(tags[i, 0]), int(tags[i, 1])
      cid = t0 // INGEST_COLLECTOR_TAG
      counts[cid] = counts.get(cid, 0) + 1
      if t0 in firsts:
        bad_pairs += 1
      firsts[t0] = halves[0][i].tobytes()
      seconds[t1] = halves[1][i].tobytes()
  shared = set(firsts) & set(seconds)
  bytes_differ = sum(firsts[t] != seconds[t] for t in shared)
  counts_ok = counts == {cid: n for cid, n in enumerate(pushed)}
  return {"frames": sum(counts.values()), "by_collector": counts,
          "pushed": pushed, "counts_equal_pushed": counts_ok,
          "bad_pairs": bad_pairs, "frames_in_two_pairs": len(shared),
          "frames_whose_bytes_differ": bytes_differ,
          "ok": counts_ok and not bad_pairs and not bytes_differ
          and len(shared) > 0}


def ingest_leg(card, name, samples_per_insert):
  """One learner of `examples/sac_train_job_torch.py` at the JAX job's
  defaults fed by `INGEST_COLLECTORS` collector processes, for
  `INGEST_LEG_STEPS` train steps; its numbers and gates."""
  import secrets

  import numpy as np
  import torch

  from agents_tpu_torch.environments.test_envs import RandomPyEnvironment
  from agents_tpu_torch.policies.policy_saver import load_manifest
  from examples import sac_train_job_torch as job
  from examples.sac_collect_job_torch import snapshot_crc32

  tag = f"{os.getpid()}_{secrets.token_hex(3)}"
  rings = [f"cs_ingest_{tag}_{i}" for i in range(INGEST_COLLECTORS)]
  shm = f"cs_weights_{tag}"
  root = os.path.join(RUNS_DIR, f"ingest_{name}_{tag}")
  argv = [f"--rings={','.join(rings)}", f"--weights_shm={shm}",
          f"--total_train_steps={INGEST_LEG_STEPS}", f"--root_dir={root}"]
  if samples_per_insert:
    argv.append(f"--samples_per_insert={samples_per_insert}")
  args = job.parse_args(argv)
  env = RandomPyEnvironment(*pendulum_specs())
  learner = job.Learner(args, env.time_step_spec(), env.action_spec())
  lim = learner.limiter
  blocks, diffs, at_sample, crcs, exported = [], [], [], {}, []
  drain, train_call, publish = (learner.drain, learner.train_call,
                                learner.publish)

  def diff():
    return lim.inserts * getattr(lim, "samples_per_insert", 0.0) - lim.samples

  def checked_drain():
    got = drain()
    blocks.extend(got)
    diffs.append(diff())
    return got

  def checked_train_call():
    at_sample.append((diff(), lim.inserts, learner.replay_state.count))
    torch.cuda.set_sync_debug_mode("error")
    try:
      train_call()
    finally:
      torch.cuda.set_sync_debug_mode(0)

  def checked_publish():
    publish()
    crcs[learner.train_steps] = snapshot_crc32(
        learner.collect_params().state_dict())
    exported.append({d: load_manifest(os.path.join(root, "policies", d))[
        "train_step"] for d in ("collect_policy", "greedy_policy")})

  learner.drain, learner.train_call, learner.publish = (
      checked_drain, checked_train_call, checked_publish)
  children = [subprocess.Popen(
      [sys.executable, os.path.abspath(__file__), "--collector", ring, shm,
       str(cid)], stdout=subprocess.PIPE, text=True)
      for cid, ring in enumerate(rings)]
  reports, leftovers = [], []
  try:
    learner.publish()
    while learner.train_steps < INGEST_LEG_STEPS:
      learner.step()
    pushes = len(crcs)
    for proc in children:
      proc.terminate()
    # Drain (without the limiter) while the collectors finish their tick,
    # so none waits on a full ring; then whatever is left.
    while any(proc.poll() is None for proc in children):
      for server in learner.servers:
        out = server.drain(max_frames=4096)
        if out is not None:
          leftovers.append(out)
      time.sleep(0.005)
    for proc in children:
      out, _ = proc.communicate(timeout=60)
      lines = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
      reports.append([l for l in lines if l.get("done")][-1])
    for server in learner.servers:
      while (out := server.drain(max_frames=4096)) is not None:
        leftovers.append(out)
    dropped = learner.dropped()
  finally:
    for proc in children:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
    learner.close()
  programs = {d: sorted(f for f in os.listdir(os.path.join(root, "policies", d))
                        if f.endswith(".pt2"))
              for d in ("collect_policy", "greedy_policy")}
  export_modes = {d: load_manifest(os.path.join(root, "policies", d))[
      "torch_export"] for d in programs}
  shutil.rmtree(root, ignore_errors=True)
  # Each publish exports both policies at its step; the steps advance.
  exports_ok = (
      [e["collect_policy"] for e in exported] == sorted(crcs)
      and [e["greedy_policy"] for e in exported] == sorted(crcs)
      and len(exported) >= 2 and exported[-1]["collect_policy"] > 0
      and all(p == ["exported_action_cpu.pt2", "exported_action_cuda.pt2"]
              for p in programs.values())
      and all(m == "batch-polymorphic" for m in export_modes.values()))
  ingested = check_ingested(blocks + leftovers,
                            [r["pushed_items"] for r in reports])
  pulls_ok = all(
      len({s for s, _ in r["pulls"]}) >= 2
      and [s for s, _ in r["pulls"]] == sorted(s for s, _ in r["pulls"])
      and all(crcs.get(s) == c for s, c in r["pulls"]) for r in reports)
  sampled_early = [s for s in at_sample
                   if s[1] < args.min_replay_items or s[2] == 0]
  chunk = learner.samples_per_chunk
  ratio_ok = True
  if samples_per_insert:
    ratio_ok = (max(diffs) <= lim.max_diff
                and min(s[0] for s in at_sample) - chunk >= lim.min_diff)
  ok = (ingested["ok"] and pulls_ok and not sampled_early and ratio_ok
        and exports_ok and learner.train_steps == INGEST_LEG_STEPS)
  return {
      "leg": name, "limiter": type(lim).__name__,
      "samples_per_insert": samples_per_insert or None,
      "train_steps": learner.train_steps,
      "items_ingested": learner.total_items, "dropped": dropped,
      "weight_pushes": pushes,
      "weight_bytes": sum(v.numel() * v.element_size() for v in
                          learner.collect_params().state_dict().values()),
      "diff_range": [min(diffs), max(diffs)] if samples_per_insert else None,
      "diff_bounds": ([lim.min_diff, lim.max_diff]
                      if samples_per_insert else None),
      "ratio_within_error_buffer": ratio_ok,
      "first_sample_at_inserts": at_sample[0][1] if at_sample else None,
      "sampled_before_min_items": len(sampled_early),
      "collector_pulls": [[s for s, _ in r["pulls"]] for r in reports],
      "pulls_untorn_and_advancing": pulls_ok,
      "collector_ticks": [r["ticks"] for r in reports],
      "export_train_steps": exported, "export_programs": programs,
      "export_modes": export_modes, "exports_advancing": exports_ok,
      "ingest": ingested, "ok": ok}


def phase_ingest_sac(card):
  """The distributed SAC learner at the JAX job's defaults (ring 32,768,
  replay 256 rows x 512, sample 256, 8 train steps per call,
  `min_replay_items` 512, SAC (256, 256), Adam 3e-4 x3) fed by two
  collector processes through the shm rings, weights through the shm
  store every 200 steps: a `MinSize` leg and a `SampleToInsertRatio` leg
  (8 samples per insert)."""
  legs = [ingest_leg(card, "min_size", 0.0),
          ingest_leg(card, "ratio", INGEST_RATIO)]
  ok = all(leg["ok"] for leg in legs)
  emit("ingest_sac", card=card, collectors=INGEST_COLLECTORS,
       collector_env_batch=INGEST_ENV_BATCH, train_steps_per_leg=
       INGEST_LEG_STEPS, sync_debug_mode="error inside each train call",
       legs=legs, ok=ok)
  if not ok:
    fail("ingest_sac", "a leg failed its gates: " + ", ".join(
        leg["leg"] for leg in legs if not leg["ok"]))


def phase_host_replay(card):
  """`bench_torch.py:host_atari_replay_probe` (84x84x4 uint8 frames in
  `PyUniformReplayBuffer` and `PyHashedReplayBuffer`), capacity cut from
  1M frames to 100k: fill frames/s, 2-step samples at batch 256, the
  sampled batch's H2D GB/s, the hashed variant's add rate and bytes
  stored, gated on the probe's checks."""
  probe = host_atari_replay_probe(capacity=HOST_REPLAY_CAPACITY,
                                  hashed_frames=HOST_REPLAY_HASHED,
                                  device="cuda")
  checks = probe.pop("checks")
  ok = all(checks.values())
  emit("host_replay", card=card, capacity_cut_from=1_000_000, **probe,
       checks=checks, ok=ok)
  if not ok:
    fail("host_replay", f"host replay checks failed: {checks}")


def replay_phases(card):
  """Prioritized replay on the fused loop, the episodic and host buffers,
  and the distributed SAC learner."""
  phase_per_parity(card)
  phase_per_main(card)
  free_card()
  phase_episodic(card)
  phase_ingest_sac(card)
  free_card()
  phase_host_replay(card)


# `bench_torch.py`'s line: `bench.py`'s top-level keys, and `bench.py`'s
# `detail` keys without `sac_halfcheetah` and with the twin's own.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "detail"}
BENCH_DETAIL_KEYS = {
    "avg_return_last20", "timed_iterations", "batch_size",
    "train_steps_per_env_batch_step", "wall_s", "chunk_ms_per_iteration",
    "atari_conv_mnih15", "atari_host_replay_1m",
    "sac_halfcheetah_live_throughput", "card", "torch", "cuda", "tf32",
    "reduced"}
BENCH_TIMEOUT_S = 300


def json_numbers(nest):
  """Every int and float in a parsed JSON nest (booleans excepted)."""
  if isinstance(nest, dict):
    nest = list(nest.values())
  if isinstance(nest, list):
    return [x for item in nest for x in json_numbers(item)]
  if isinstance(nest, (int, float)) and not isinstance(nest, bool):
    return [nest]
  return []


def bench_line_checks(line, card):
  """The checks of `bench`'s line against `card` (`card_line()`)."""
  detail = line.get("detail", {})
  name, power_limit = (f.strip() for f in card.rsplit(",", 1))
  value, avg_return = line.get("value"), detail.get("avg_return_last20")
  return {
      "keys": set(line) == BENCH_KEYS,
      "detail_keys": set(detail) == BENCH_DETAIL_KEYS,
      "numbers_finite": all(math.isfinite(x) for x in json_numbers(line)),
      "value_zero_iff_unsolved": (
          value is not None and avg_return is not None
          and (value == 0) == (avg_return < 195)),
      "card": detail.get("card") == {"name": name,
                                     "power_limit": power_limit},
      "tf32_off": detail.get("tf32") == {"matmul": False, "cudnn": False},
      "smoke_cuts_listed": bool(detail.get("reduced"))}


def phase_bench(card):
  """`bench_torch.py --smoke` in a child process, its line checked."""
  t0 = time.perf_counter()
  out = subprocess.run(
      [sys.executable, "bench_torch.py", "--smoke"],
      cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
      text=True, timeout=BENCH_TIMEOUT_S)
  if out.returncode != 0:
    fail("bench", f"bench_torch.py --smoke exited with {out.returncode}: "
         f"{out.stderr[-3000:]}")
  line = json.loads(out.stdout.strip().splitlines()[-1])
  checks = bench_line_checks(line, card)
  ok = all(checks.values())
  emit("bench", card=card, line=line, checks=checks,
       seconds=time.perf_counter() - t0, ok=ok)
  if not ok:
    fail("bench", f"bench_torch.py's line failed its checks: {checks}")


# The learning runs, each in a process of its own (see `learning_phases`).
CHILD_PHASES = {"td3_learn": phase_td3_learn, "offline": phase_offline,
                "qtopt_learn": phase_qtopt_learn,
                "ppo_rnn_learn": phase_ppo_rnn_learn,
                "per_learn": phase_per_learn,
                "surface_bernoulli_ts": phase_surface_bernoulli_ts}


# Phases that time nothing and whose gates repeat bit for bit, run beside
# the learning children once `sac_learn` is done.
UNTIMED_PHASES = (phase_bandit_learn, phase_bandit_scenarios,
                  phase_discrete_parity, phase_rnn_parity, phase_parallel_env)


def learning_phases(card):
  """`sac_learn` here while `td3_learn`, `cql_offline` + `bc`,
  `qtopt_learn`, `ppo_rnn_learn`, `per_learn` and
  `surface_bernoulli_ts` run in six child processes of this script on the
  same card. Each learning run is a long run of small host-bound steps
  (the card idles over 90% of the time), so they take about as long at
  once as the longest on the host's cores; no timed phase runs beside
  them, only, after `sac_learn`, the untimed phases of
  `UNTIMED_PHASES`. The children's lines are printed as each ends; a child
  that fails fails the script, and no child outlives it."""
  children = {
      name: subprocess.Popen(
          [sys.executable, os.path.abspath(__file__), "--child", name],
          stdout=subprocess.PIPE, text=True)
      for name in CHILD_PHASES}
  try:
    phase_sac_learn(card)
    for phase in UNTIMED_PHASES:
      phase(card)
    free_card()
    for name, proc in children.items():
      out, _ = proc.communicate(timeout=CHILD_TIMEOUT_S)
      sys.stdout.write(out)
      sys.stdout.flush()
      if proc.returncode != 0:
        fail(name, f"its process exited with {proc.returncode}")
  finally:
    for proc in children.values():
      if proc.poll() is None:
        proc.kill()
        proc.wait()


def main(argv=()):
  if list(argv[:1]) == ["--collector"]:
    # A collector of `ingest_sac`: on the CPU, it never touches the card.
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    ingest_collector(*argv[1:])
    return 0
  import torch

  if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; this script "
          "needs a CUDA card", file=sys.stderr)
    return 1
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  import agents_tpu_torch  # noqa: F401  (fails outside the repository)

  card = card_line()
  if len(argv) == 2 and argv[0] == "--child":
    CHILD_PHASES[argv[1]](card)
    return 0
  if len(argv) == 2 and argv[0] == "--eval-job":
    eval_job_child(argv[1])
    return 0
  print(card, flush=True)
  emit("device", torch=torch.__version__, cuda=torch.version.cuda,
       name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
       nvidia_smi=card, host_cpus=os.cpu_count(),
       host_loadavg=os.getloadavg())
  phase_parity()
  loop, state = phase_main_and_learn(card)
  phase_eval(loop, state, card)
  root, export_step, state = phase_learner_export(loop, state, card)
  phase_eval_job(loop, state, card, root, export_step)
  del loop, state
  free_card()
  phase_data_parallel(card)
  bandit_phases(card)
  phase_surface(card)
  free_card()
  phase_conv_parity(card)
  phase_conv_main(card)
  free_card()
  phase_conv_learn(card)
  phase_c51(card)
  free_card()
  phase_sac_parity(card)
  phase_sac_main(card)
  free_card()
  phase_ppo_parity(card)
  cfg, loop, state, iterations = phase_ppo_main(card)
  phase_ppo_learn(card, cfg, loop, state, iterations)
  del loop, state
  phase_ppo_schulman17(card)
  phase_reinforce(card)
  free_card()
  phase_td3_parity(card)
  phase_td3_main(card)
  free_card()
  phase_cql_parity(card)
  phase_cql_main(card)
  free_card()
  phase_qtopt_parity(card)
  phase_qtopt_main(card)
  free_card()
  phase_rnn_dqn_main(card)
  free_card()
  phase_ppo_rnn_main(card)
  phase_checkpoint_resume(card)
  free_card()
  host_phases(card)
  host_example_phases(card)
  replay_phases(card)
  free_card()
  phase_bench(card)
  kernel = phase_lstm_kernel(card)
  free_card()
  learning_phases(card)
  emit("kernels", note="agents_tpu has no Pallas kernel at HEAD; the port's "
       "one hand-written kernel is the LSTM recurrence (lstm_kernel)",
       kernels=[kernel])
  emit("total", seconds=CLOCK.total())
  print(json.dumps({"kernels": [kernel]}), flush=True)
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main(sys.argv[1:]))
