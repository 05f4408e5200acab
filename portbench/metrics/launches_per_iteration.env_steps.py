"""Device operations (kernels, copies, sets) per fused iteration in the
profiled sub-window."""
from portbench.reads import launches_per_iteration as read  # noqa: F401
