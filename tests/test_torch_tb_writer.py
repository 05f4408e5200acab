"""`agents_tpu_torch.utils.tb_writer` against the JAX package's writer.

Given the same wall time (``time.time`` patched for both), the two
writers emit the same bytes for the same scalars and histograms; the
official tensorboard loader reads the port's files back (the JAX tests'
checks, ``tests/test_tb_writer.py``); `MultiWriter` fans out to the
port's `JsonlSummaryWriter` and skips writers without a histogram
surface. Numbers read back compare at rtol 1e-6 (float32 scalars).
"""
import os
import time

import numpy as np
import pytest
import torch

from agents_tpu.utils import tb_writer as jax_tb
from agents_tpu_torch.train import JsonlSummaryWriter, MultiWriter
from agents_tpu_torch.train import TensorBoardEventWriter
from agents_tpu_torch.utils import tb_writer

event_accumulator = pytest.importorskip(
    "tensorboard.backend.event_processing.event_accumulator")


def _write_all(module, logdir):
  w = module.TensorBoardEventWriter(str(logdir))
  for step in range(5):
    w.scalar("loss", 1.0 / (step + 1), step)
    w.scalar("return", 10.0 * step, step)
  rng = np.random.RandomState(0)
  w.histogram("weights", rng.normal(2.0, 1.0, size=1000), step=3, bins=20)
  w.histogram_from_counts("actions", [5, 0, 12], step=3)
  w.histogram_from_counts("limits", [1, 2], step=4, limits=[0.5, 1.5])
  w.close()
  (name,) = os.listdir(logdir)
  with open(os.path.join(logdir, name), "rb") as f:
    return name, f.read()


def test_records_byte_equal_to_jax_at_the_same_wall_time(tmp_path,
                                                         monkeypatch):
  monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
  jname, jbytes = _write_all(jax_tb, tmp_path / "jax")
  tname, tbytes = _write_all(tb_writer, tmp_path / "torch")
  assert tname == jname
  assert tbytes == jbytes
  assert len(tbytes) > 0


def test_masked_crc_matches_jax_and_the_check_value():
  c = 0xE3069283  # crc32c("123456789"), the Castagnoli check value
  want = (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF
  assert tb_writer._masked_crc(b"123456789") == want
  for data in (b"", b"\x00" * 7, bytes(range(256))):
    assert tb_writer._masked_crc(data) == jax_tb._masked_crc(data)


def test_events_file_readable_by_tensorboard(tmp_path):
  w = TensorBoardEventWriter(str(tmp_path))
  for step in range(5):
    w.scalar("loss", 1.0 / (step + 1), step)
    w.scalar("return", torch.tensor(10.0 * step), step)
  w.close()
  acc = event_accumulator.EventAccumulator(str(tmp_path))
  acc.Reload()
  assert {"loss", "return"} <= set(acc.Tags()["scalars"])
  loss = acc.Scalars("loss")
  assert [e.step for e in loss] == list(range(5))
  np.testing.assert_allclose([e.value for e in loss],
                             [1.0 / (s + 1) for s in range(5)], rtol=1e-6)
  np.testing.assert_allclose([e.value for e in acc.Scalars("return")],
                             [10.0 * s for s in range(5)], rtol=1e-6)


def test_histograms_readable_by_tensorboard(tmp_path):
  w = TensorBoardEventWriter(str(tmp_path))
  vals = np.random.RandomState(0).normal(2.0, 1.0, size=1000)
  w.histogram("weights", torch.as_tensor(vals), step=3, bins=20)
  w.histogram_from_counts("actions", torch.tensor([5, 0, 12]), step=3)
  w.close()
  acc = event_accumulator.EventAccumulator(
      str(tmp_path), size_guidance={event_accumulator.HISTOGRAMS: 0})
  acc.Reload()
  assert {"weights", "actions"} <= set(acc.Tags()["histograms"])
  hw = acc.Histograms("weights")[0].histogram_value
  assert hw.num == 1000
  np.testing.assert_allclose(hw.min, vals.min())
  np.testing.assert_allclose(hw.max, vals.max())
  np.testing.assert_allclose(hw.sum, vals.sum())
  np.testing.assert_allclose(sum(hw.bucket), 1000)
  ha = acc.Histograms("actions")[0].histogram_value
  np.testing.assert_allclose(list(ha.bucket), [5, 0, 12])
  np.testing.assert_allclose(list(ha.bucket_limit), [0, 1, 2])
  assert ha.num == 17 and ha.sum == 24


def test_multi_writer_fans_out_and_skips_scalar_only(tmp_path):
  class ScalarOnly:
    def __init__(self):
      self.calls = []

    def scalar(self, name, value, step):
      self.calls.append((name, value, step))

    def close(self):
      pass

  so = ScalarOnly()
  jsonl = tmp_path / "log.jsonl"
  w = MultiWriter(JsonlSummaryWriter(str(jsonl)), so,
                  TensorBoardEventWriter(str(tmp_path / "tb")))
  w.scalar("x", 3.0, 7)
  w.histogram("h", [1.0, 2.0], 0)
  w.histogram_from_counts("c", [1, 2], 0)
  w.close()
  assert '"x": 3.0' in jsonl.read_text()
  assert so.calls == [("x", 3.0, 7)]
  assert any(f.name.startswith("events.out.tfevents")
             for f in (tmp_path / "tb").iterdir())
