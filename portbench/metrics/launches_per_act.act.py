"""Device operations (kernels, copies, sets) per act call in the profiled sub-
window."""
from portbench.reads import launches_per_call as read  # noqa: F401
