"""Model FLOPs of a SAC train step over its device time in the profiled
sub-window, as a share of the card's peak in the configuration's precision
(%)."""
from portbench.reads import step_mfu_train_steps as read  # noqa: F401
