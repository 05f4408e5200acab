"""Least time of an iteration's convolutions over the device time the profiler
gives their forward and backward operators (%)."""
from portbench.reads import conv_roofline as read  # noqa: F401
