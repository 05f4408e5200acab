"""% of the LSTM's forward time steps that ran the CUDA recurrence kernel:
the program's `lstm.kernel_steps` counter over its `lstm.steps`, in the
recorded stretch after the fused iterations' timed window
(`portbench/spans.py`). None where the program keeps no such counter."""
from portbench import spans


def read(run):
  got = spans.stretches(run)
  if got is None:
    return None
  counters = got["recorded"]["summary"]["counters"]
  kernel, steps = (counters.get("lstm.kernel_steps"),
                   counters.get("lstm.steps"))
  if kernel is None or not steps:
    return None
  return 100.0 * kernel / steps
