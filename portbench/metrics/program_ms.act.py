"""ms of the loaded export program's call alone, inputs on the card, host clock
over many calls to a synchronize."""
from portbench.reads import program_ms as read  # noqa: F401
