"""Host-clock ms of the gradient average, clipping, optimizer steps and target
update (`agent.apply`) per train step (the `agent.train_steps` counter),
from the recorded stretch of the program's own spans after the SAC train
steps' timed window (`portbench/spans.py`)."""
from portbench import spans


def read(run):
  return spans.span_ms(run, "agent.apply", "train_steps")
