"""ms of one SAC train step alone on sampled batches, host clock over many
calls to a synchronize."""
from portbench.reads import train_step_ms as read  # noqa: F401
