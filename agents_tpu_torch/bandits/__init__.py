"""Contextual bandits (port of ``agents_tpu/bandits``)."""
