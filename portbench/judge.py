"""The numbers that decide `correct`, worked out against the reference.

A training cell's set-up drives the program from the seed through its
first steps by the window's own call (`FusedTrainLoop.run`) and keeps
what it produced: the ring's frames, each followed step's losses, the
first gradient as the optimizer got it, and every leaf before and after
the followed steps. The reference follows the same steps on the same
inputs (the benchmark's weights and the draws handed to the program) and
plays the program's actions, judging each; its own precision is float32
with TF32 off. An act cell's calls are judged by the gap of each action's
reference Q value below the reference's best.

The numbers (each with its limit in ``limits/<cell>.json``):

  ring_mismatch     ring elements that differ from the reference's (every
                    leaf is exact: the same operations on the same inputs)
  explore_mismatch  rows that explored but did not play their random draw
  td_gap            widest absolute gap of a sampled row's TD error
  td_rms_gap        root mean square of the rows' TD error gaps over that
                    of the reference's TD errors, over the followed steps
  td_rounding_units the root mean square of the rows' TD error gaps over
                    that of a reference in the configuration's precision
                    (`adapter.ROUNDING`): the gap in units of the rounding
                    the configuration states
  greedy_gap        widest gap of a greedy action's reference Q below the
                    reference's best
  collect_gap       widest absolute gap of a collected continuous action
                    from the reference actor's at the same draw
  loss_gap          per kind of loss, the largest gap over the steps over
                    the largest reference loss; the worst kind
  grad_gap          worst leaf's gap of gradient norms (`common.norm_gaps`)
  update_gap        the same of each leaf's change over the followed
                    steps, over the leaves the reference's gradient moves
                    (`common.moved_leaves`)
  target_mismatch   elements of the target network, around the first
                    train step that updates it after the followed ones,
                    that differ from the reference's rule: unchanged since
                    the followed steps until that step, then
                    tau * online + (1 - tau) * target (exact for the hard
                    update, tau 1, that the DQN states)
  sample_mismatch   elements of the windows that a train step after the
                    window was handed, from the ring as the window left
                    it (full and wrapped where the cell fills it), that
                    differ from the ring's slots the reference picks with
                    the same draws (`common.ring_windows`)
"""
from __future__ import annotations

import math
import sys

import torch

from portbench.reference import common


def training_numbers(adapter, hp, weights, records, produced, follow_args,
                     precision: str = "float32") -> dict:
  """The numbers of `produced` (the program's, or a control's, outputs)
  against the reference at `precision` over the same inputs."""
  try:
    truth = follow(adapter, hp, weights, records, follow_args, precision,
                   actions=produced["actions"])
  except (LookupError, ValueError) as e:
    # The program drew other draws, or other shapes, than the steps it
    # took need: nothing it produced can be judged.
    print(f"portbench: the reference cannot follow: {e}", file=sys.stderr)
    return {}
  ring_p, ring_r = produced["ring"], truth["ring"]
  numbers = {"ring_mismatch": sum(_mismatch(ring_p[k], ring_r[k])
                                  for k in adapter.EXACT_RING)}
  for key in adapter.FOLLOW_NUMBERS:
    numbers[key] = truth[key]
  if produced.get("td_error"):
    p_td = torch.cat(produced["td_error"]).double()
    r_td = torch.cat(truth["td_error"]).double()
    numbers["td_gap"] = numbers["td_rms_gap"] = math.inf
    if p_td.shape == r_td.shape:
      numbers["td_gap"] = float((p_td - r_td).abs().max())
      rms = float((p_td - r_td).square().mean().sqrt())
      numbers["td_rms_gap"] = rms / float(r_td.square().mean().sqrt())
      if adapter.ROUNDING:
        rounded = follow(adapter, hp, weights, records, follow_args,
                         adapter.ROUNDING, actions=produced["actions"])
        yardstick = torch.cat(rounded["td_error"]).double() - r_td
        numbers["td_rounding_units"] = rms / float(
            yardstick.square().mean().sqrt())
  numbers["loss_gap"] = common.loss_gap(produced["losses"], truth["losses"])
  numbers["loss_gap_first"] = common.loss_gap(produced["losses"][:1],
                                              truth["losses"][:1])
  grads = common.norm_gaps(produced["grads"], truth["grads"])
  numbers["grad_gap"] = max(grads.values())
  numbers["grad_gap_median"] = common.median(list(grads.values()))
  change = {k: produced["after"][k] - produced["before"][k]
            for k in truth["after"]}
  truth_change = {k: truth["after"][k] - truth["before"][k]
                  for k in truth["after"]}
  moved = common.moved_leaves(truth["grads"], list(truth_change),
                              adapter.source_of)
  updates = common.norm_gaps(change, truth_change, moved)
  numbers["update_gap"] = max(updates.values())
  numbers["update_gap_median"] = common.median(
      [updates[k] for k in moved if truth_change[k].abs().max() > 0])
  numbers["worst_leaves"] = [max(grads, key=grads.get),
                             max(updates, key=updates.get)]
  if produced.get("target_update"):
    numbers["target_mismatch"] = _target_mismatch(
        adapter, hp, truth["after"], produced["target_update"])
  return numbers


def _target_mismatch(adapter, hp, truth_after, kept) -> int:
  """`kept` holds every leaf just before and just after the program's
  first target update past the followed steps."""
  tau = hp["target_update_tau"]
  out = 0
  for name, reference in truth_after.items():
    if not name.startswith("target."):
      continue
    before = kept["before"][name]
    out += _mismatch(before, reference)
    online = kept["after"][adapter.source_of(name)]
    out += _mismatch(kept["after"][name], before * (1 - tau) + online * tau)
  return out


def sample_numbers(storage, count: int, capacity: int, records,
                   windows) -> dict:
  """sample_mismatch of `windows` ({leaf: [S, n, ...]}, what the first
  train step of an iteration was handed) against the ring `storage`
  ({leaf: [capacity, B, ...]}) holding `count` frames, picked by that
  step's recorded draws."""
  try:
    draws = common.Recorded(records)
    sample, n = next(iter(windows.values())).shape[:2]
    t0, rows = draws.take("replay_t0", (sample,)), draws.take(
        "replay_rows", (sample,))
  except (LookupError, ValueError) as e:
    print(f"portbench: the sample cannot be judged: {e}", file=sys.stderr)
    return {"sample_mismatch": math.inf}
  truth = common.ring_windows({k: storage[k] for k in windows}, count,
                              capacity, t0, rows, n)
  return {"sample_mismatch": sum(_mismatch(windows[k], truth[k])
                                 for k in windows)}


def _mismatch(produced, reference) -> int:
  """Elements that differ; every element where the shapes differ."""
  if produced.shape != reference.shape:
    return max(produced.numel(), reference.numel())
  return int((produced.to(reference.dtype) != reference).sum())


def follow(adapter, hp, weights, records, follow_args, precision: str,
           **kwargs) -> dict:
  """The adapter's reference over the recorded draws, at `precision`:
  judging `actions=` (the program's), or in the program's place with a
  `fault=` planted."""
  return adapter.REFERENCE.follow(hp, weights, common.Recorded(records),
                                  *follow_args, precision=precision,
                                  **kwargs)


def act_numbers(adapter, hp, weights, obs, actions,
                precision: str = "float32") -> dict:
  """greedy_gap of `actions` on `obs` against the reference's Q values,
  and bad_actions, the actions outside the spec."""
  q = adapter.act_q_values(hp, weights, obs, precision)
  actions = actions.to(q.device).long()
  bad = (actions < 0) | (actions >= q.shape[-1])
  taken = q.gather(1, actions.clamp(0, q.shape[-1] - 1)[:, None])[:, 0]
  gap = torch.where(bad, 0.0, q.max(dim=-1).values - taken)
  return {"bad_actions": int(bad.sum()), "greedy_gap": float(gap.max())}


def limits_hold(numbers: dict, limits: dict) -> bool:
  """Every number at or below its limit (and none missing or NaN)."""
  return all(numbers.get(name) is not None and numbers[name] <= limit
             for name, limit in limits.items())
