"""Device operations (kernels, copies, sets) per train step in the profiled
sub-window."""
from portbench.reads import launches_per_train_step as read  # noqa: F401
