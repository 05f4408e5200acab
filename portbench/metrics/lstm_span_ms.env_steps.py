"""Host-clock ms of the LSTM's forward time loops (`lstm.unroll`) and
written-out backward (`lstm.backward`) per `loop.iteration` entry, from
the recorded stretch of the program's own spans after the fused
iterations' timed window (`portbench/spans.py`). None where the program
opens neither span."""
from portbench import lstm, spans


def read(run):
  got = [spans.span_ms(run, name, "iterations") for name in lstm.SPANS]
  got = [ms for ms in got if ms is not None]
  return sum(got) if got else None
