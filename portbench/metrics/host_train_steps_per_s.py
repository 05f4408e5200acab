"""Train steps completed in the timed window of fused SAC iterations over
its host-clock seconds (train-steps/s)."""
from portbench.reads import host_train_steps_per_s as read  # noqa: F401
