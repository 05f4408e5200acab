"""agents_tpu_torch: the PyTorch/CUDA port of `agents_tpu`.

The port sits beside the JAX package and imports nothing of it (nor JAX,
flax or optax); each ported module names its JAX counterpart in its
docstring. This slice carries the fused DQN-on-CartPole main path and its
greedy-eval path:

  typing, utils     - aliases, nests (`nest_utils`), losses and target
                      updates (`common`), device resolution (`device`),
                      random draw sources (`draws`), flax->torch weight
                      conversion (`convert`)
  specs             - ArraySpec / BoundedArraySpec
  trajectories      - TimeStep, PolicyStep, Trajectory, n-step transitions
  environments      - BatchedTorchEnv (lockstep auto-reset), CartPole
  distributions     - Categorical
  networks          - EncoderModule (MLP branch), QModule (nn.Modules)
  policies          - QPolicy, GreedyPolicy, EpsilonGreedyPolicy
  ops               - gather_rows (replay row gather)
  replay_buffers    - UniformReplay (time-major ring on the device)
  agents            - DqnAgent, DdqnAgent
  metrics           - collect metrics as device-tensor reducers
  drivers           - TorchDriver, TorchEpisodeDriver
  train             - FusedTrainLoop

Entry points take `device=` and default to "cuda"; without a GPU they raise
unless the caller passes `device="cpu"`.
"""
