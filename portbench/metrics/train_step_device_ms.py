"""ms of device time per SAC train step: the union of the device spans of
the profiled sub-window of fused iterations over its train steps. An
end-to-end metric, read in every run of the cells that report it."""
from portbench.reads import train_step_device_ms as read  # noqa: F401
