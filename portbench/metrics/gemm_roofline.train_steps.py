"""Least time of a SAC train step's dense GEMMs over the device time the
profiler gives the matmul operators per train step (%)."""
from portbench.reads import gemm_roofline as read  # noqa: F401
