"""Least time of an iteration's two CEM optimizations (`portbench/
qtopt.py`: `cem_least_s_per_iteration`, their convolutions, pools and
dense layers at the float32 peak and HBM bandwidth) over the device time
of the operations launched inside `cem.optimize` per iteration, from a
profiled stretch of two iterations (%). None where the program opens no
such span."""
from portbench import qtopt


def read(run):
  least = (run.model or {}).get("cem_least_s_per_iteration")
  seconds = qtopt.span_device_seconds(run)
  if not least or not seconds:
    return None
  return 100.0 * least / seconds
