"""Least time of an iteration's recurrence (`portbench/lstm.py`:
`recurrence_least_seconds`, its products and bytes at the float32 peak
and HBM bandwidth) over the device time of the operations launched inside
the LSTM's spans (`lstm.unroll`, `lstm.backward`) per iteration, from a
profiled stretch of two iterations (%). None where the program opens
neither span."""
from portbench import lstm


def read(run):
  least = (run.model or {}).get("lstm_least_s_per_iteration")
  seconds = lstm.span_device_seconds(run)
  if not least or not seconds:
    return None
  return 100.0 * least / seconds
