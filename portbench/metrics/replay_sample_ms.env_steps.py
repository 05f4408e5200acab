"""ms of one replay sample of the train step's windows alone, host clock over
many calls to a synchronize."""
from portbench.reads import replay_sample_ms as read  # noqa: F401
