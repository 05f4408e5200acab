"""Supervised-dataset loaders for classification bandits.

Port of ``agents_tpu/bandits/environments/dataset_utilities.py`` (its own
copy: the port imports nothing of the JAX package). Loaders return numpy
arrays that feed `ClassificationBandit`, which keeps the dataset on the
device; `mushroom_reward_sampler` draws its Bernoulli at the site
"mushroom_poison" (uniform [B]).
"""
from __future__ import annotations

import csv
import os
from typing import Tuple

import numpy as np
import torch


def one_hot_table(data: np.ndarray) -> np.ndarray:
  """One-hot encodes a [N, C] table of categorical codes column by
  column."""
  cols = []
  for c in range(data.shape[1]):
    col = data[:, c]
    _, inv = np.unique(col, return_inverse=True)
    width = inv.max() + 1
    onehot = np.zeros((len(col), width), np.float32)
    onehot[np.arange(len(col)), inv] = 1.0
    cols.append(onehot)
  return np.concatenate(cols, axis=1)


def _read_csv(file_path: str):
  if not os.path.exists(file_path):
    raise FileNotFoundError(
        f"{file_path} not found; download the UCI dataset to use this "
        "loader (no dataset is bundled).")
  with open(file_path, newline="") as f:
    return [row for row in csv.reader(f) if row]


def load_mushroom_csv(file_path: str,
                      max_rows: int = 40000) -> Tuple[np.ndarray, np.ndarray]:
  """UCI mushroom CSV -> (one-hot contexts [N, d], labels [N]).

  Column 0 is the class ('e' edible = label 0, 'p' poisonous = label 1),
  the remaining 22 categorical columns become one-hot features.
  """
  rows = _read_csv(file_path)[:max_rows]
  table = np.asarray(rows)
  if table.shape[1] != 23:
    raise ValueError(f"mushroom data must have 23 columns, got "
                     f"{table.shape[1]}")
  labels = (table[:, 0] == "p").astype(np.int32)
  contexts = one_hot_table(table[:, 1:])
  return contexts, labels


def mushroom_reward_sampler(r_noeat: float = 0.0, r_eat_safe: float = 5.0,
                            r_eat_poison_bad: float = -35.0,
                            r_eat_poison_good: float = 5.0,
                            prob_poison_bad: float = 0.5):
  """Stochastic mushroom rewards: action 0 = no-eat (always r_noeat);
  action 1 = eat — safe mushrooms pay r_eat_safe, poisonous ones pay
  r_eat_poison_bad w.p. prob_poison_bad else r_eat_poison_good.

  Returns (sampler(label, action, draws) -> reward, expected_table [2, 2])
  for `ClassificationBandit(reward_sampler=...)`; the expected table
  drives the regret metric.
  """
  expected_poison_eat = (prob_poison_bad * r_eat_poison_bad
                         + (1.0 - prob_poison_bad) * r_eat_poison_good)
  # rows: label (0 edible, 1 poisonous); cols: action (0 no-eat, 1 eat)
  expected = np.asarray([[r_noeat, r_eat_safe],
                         [r_noeat, expected_poison_eat]], np.float32)

  def sampler(label, action, draws):
    bad = draws.uniform("mushroom_poison", label.shape) < prob_poison_bad
    poison_eat = torch.where(bad, r_eat_poison_bad, r_eat_poison_good)
    eat = torch.where(label == 0, r_eat_safe, poison_eat)
    return torch.where(action == 0, r_noeat, eat).to(torch.float32)

  return sampler, expected


def convert_covertype_dataset(
    file_path: str, max_rows: int = 40000) -> Tuple[np.ndarray, np.ndarray]:
  """UCI covertype CSV -> (float contexts [N, 54], labels [N] in [0, 6])
  (labels are 1-based in the raw file)."""
  rows = _read_csv(file_path)[:max_rows]
  table = np.asarray(rows, np.float32)
  contexts = table[:, :-1]
  labels = table[:, -1].astype(np.int32) - 1
  return contexts, labels


def classification_reward_table(num_classes: int, num_actions: int,
                                correct: float = 1.0,
                                incorrect: float = 0.0) -> np.ndarray:
  """Identity-style reward table: action == label pays `correct`."""
  table = np.full((num_classes, num_actions), incorrect, np.float32)
  k = min(num_classes, num_actions)
  table[np.arange(k), np.arange(k)] = correct
  return table
