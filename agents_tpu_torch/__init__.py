"""agents_tpu_torch: the PyTorch/CUDA port of `agents_tpu`.

The port sits beside the JAX package and imports nothing of it (nor JAX,
flax or optax); each ported module names its JAX counterpart in its
docstring. It carries fused DQN on CartPole, the pixel DQN path (conv Q
networks, D3QN, C51 on SyntheticPixels and Catch), fused SAC on the device
Pendulum, PPO and REINFORCE on the on-policy loop (CartPole and the
device Pendulum), TD3 and DDPG on the device Pendulum, and CQL-SAC and
behavioural cloning from a dataset on disk, each with its greedy-eval
path, and the host side: numpy environments on the host (gymnasium,
MuJoCo) feeding the learner on the card through three host-device loops:

  typing, utils     - aliases, nests (`nest_utils`), losses, target
                      updates and log-prob/entropy sums (`common`),
                      returns and GAE (`value_ops`), streaming and EMA
                      normalizers (`tensor_normalizer`), device
                      resolution (`device`), random draw sources
                      (`draws`), flax->torch weight conversion
                      (`convert`), offline datasets on disk
                      (`dataset_io`)
  specs             - ArraySpec / BoundedArraySpec
  trajectories      - TimeStep, PolicyStep, Trajectory, transitions
  environments      - BatchedTorchEnv (lockstep auto-reset), CartPole,
                      SyntheticPixels, Catch, Pendulum; host envs:
                      PyEnvironment, the 16 wrappers, gymnasium
                      (suite_gym), BatchedPyEnvironment,
                      ParallelPyEnvironment, test envs
  distributions     - Categorical, Normal, Independent, SquashedNormal,
                      Deterministic, kl_divergence
  networks          - EncoderModule, Q modules, ActorDistributionModule
                      with CategoricalProjection, NormalProjection or
                      TanhNormalProjection, DeterministicActorModule,
                      ValueModule, CriticModule
  policies          - JittedPyPolicy (numpy in, numpy out), QPolicy,
                      CategoricalQPolicy, ActorPolicy (with the
                      observation normalizer), DeterministicActorPolicy,
                      RandomPolicy, GreedyPolicy, EpsilonGreedyPolicy,
                      GaussianPolicy, OUNoisePolicy
  ops               - gather_rows (replay row gather)
  replay_buffers    - UniformReplay (time-major ring on the device,
                      `add_sequence` for datasets)
  agents            - DqnAgent, DdqnAgent, D3qnAgent, CategoricalDqnAgent,
                      SacAgent, PPOAgent (PPOPolicy, PPOClipAgent,
                      PPOKLPenaltyAgent), ReinforceAgent, Td3Agent,
                      DdpgAgent, CqlSacAgent, BehavioralCloningAgent,
                      RandomAgent, FixedPolicyAgent
  metrics           - collect metrics as device-tensor reducers; numpy
                      py_metrics for host drivers
  drivers           - TorchDriver (optionally returning the rollout),
                      TorchEpisodeDriver, PyDriver
  eval              - evaluate_torch_env_episodes (exactly N episodes),
                      compute (host envs)
  train             - FusedTrainLoop, OnPolicyTrainLoop, Checkpointer,
                      HostDeviceTrainLoop, HostOnPolicyTrainLoop,
                      AsyncHostDeviceTrainLoop

Entry points take `device=` and default to "cuda"; without a GPU they raise
unless the caller passes `device="cpu"`.
"""
