"""Metric export helpers.

Port of ``agents_tpu/metrics/export_utils.py``: `export_metrics` logs the
results of host metrics and writes them to a summary writer.
"""
from __future__ import annotations

import logging
from typing import Sequence


def export_metrics(step: int, metrics: Sequence, summary_writer=None,
                   prefix: str = "") -> dict:
  """{name: float(result)} of `metrics` (named ``prefix/name`` with a
  prefix), logged and, with a `summary_writer`, written at `step`."""
  results = {}
  for m in metrics:
    name = f"{prefix}/{m.name}" if prefix else m.name
    value = float(m.result())
    results[name] = value
    if summary_writer is not None:
      summary_writer.scalar(name, value, step)
  logging.info("step %d: %s", step, results)
  return results
