"""Host-clock ms of `torch.autograd.grad` (`agent.grad`) per train step (the
`agent.train_steps` counter), from the recorded stretch of the program's own
spans after the SAC train steps' timed window (`portbench/spans.py`)."""
from portbench import spans


def read(run):
  return spans.span_ms(run, "agent.grad", "train_steps")
