"""Model FLOPs of the window's fused iterations over its seconds, as a share of
the card's peak in the configuration's precision (%)."""
from portbench.reads import step_mfu_iterations as read  # noqa: F401
