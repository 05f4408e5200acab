"""Host-clock ms of the copies to the card (`act.upload`) per `act.call` entry,
from the recorded stretch of the program's own spans after the act calls'
timed window (`portbench/spans.py`)."""
from portbench import spans


def read(run):
  return spans.span_ms(run, "act.upload", "calls")
