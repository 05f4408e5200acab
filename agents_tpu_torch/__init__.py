"""agents_tpu_torch: the PyTorch/CUDA port of `agents_tpu`.

The port sits beside the JAX package and imports nothing of it (nor JAX,
flax or optax); each ported module names its JAX counterpart in its
docstring. It carries fused DQN on CartPole, the pixel DQN path (conv Q
networks, D3QN, C51 on SyntheticPixels and Catch), fused SAC on the device
Pendulum, and PPO and REINFORCE on the on-policy loop (CartPole and the
device Pendulum), each with its greedy-eval path:

  typing, utils     - aliases, nests (`nest_utils`), losses, target
                      updates and log-prob/entropy sums (`common`),
                      returns and GAE (`value_ops`), streaming and EMA
                      normalizers (`tensor_normalizer`), device
                      resolution (`device`), random draw sources
                      (`draws`), flax->torch weight conversion
                      (`convert`)
  specs             - ArraySpec / BoundedArraySpec
  trajectories      - TimeStep, PolicyStep, Trajectory, transitions
  environments      - BatchedTorchEnv (lockstep auto-reset), CartPole,
                      SyntheticPixels, Catch, Pendulum
  distributions     - Categorical, Normal, Independent, SquashedNormal,
                      Deterministic, kl_divergence
  networks          - EncoderModule, Q modules, ActorDistributionModule
                      with CategoricalProjection, NormalProjection or
                      TanhNormalProjection, ValueModule, CriticModule
  policies          - QPolicy, CategoricalQPolicy, ActorPolicy (with the
                      observation normalizer), GreedyPolicy,
                      EpsilonGreedyPolicy
  ops               - gather_rows (replay row gather)
  replay_buffers    - UniformReplay (time-major ring on the device)
  agents            - DqnAgent, DdqnAgent, D3qnAgent, CategoricalDqnAgent,
                      SacAgent, PPOAgent (PPOPolicy, PPOClipAgent,
                      PPOKLPenaltyAgent), ReinforceAgent
  metrics           - collect metrics as device-tensor reducers
  drivers           - TorchDriver (optionally returning the rollout),
                      TorchEpisodeDriver
  eval              - evaluate_torch_env_episodes (exactly N episodes)
  train             - FusedTrainLoop, OnPolicyTrainLoop

Entry points take `device=` and default to "cuda"; without a GPU they raise
unless the caller passes `device="cpu"`.
"""
