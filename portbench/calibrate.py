"""The readings that the limits of ``limits/<cell>.json`` are set from.

  python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
      --controls 1,2,3 [--seconds 2] [--device cuda]

For each seed of `--seeds`: one run of the cell (a short window, no
trace) and its numbers, the program's readings. For each seed of
`--controls`, on that run's inputs: the control, the reference put in the
program's place in the precision below the configuration's (the file's
``control``: fp8 under bfloat16, TF32 under float32); and for a training
cell the faults planted in the reference: half of the batch left out
("half_batch") and one answer altered where it is produced ("altered").
A state left unchanged reads 1 on `update_gap` and needs no run. One
JSON line per seed, then the largest program reading and the smallest of
each control and fault per number. The benchmark's own runs do not run
this.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeds(text):
  return [int(s) for s in text.split(",") if s]


def readings(cell, seed, seconds, device, controls: bool):
  import torch

  from portbench import harness, judge

  run = harness.execute(cell, seed, seconds, False, device)
  out = {"seed": seed, "program": run.numbers}
  if not controls:
    return out
  adapter, hp, judged = run.adapter, run.hp, run.judged
  precision = run.config["control"]
  if "obs" in judged:
    q = adapter.act_q_values(hp, judged["weights"], judged["obs"], precision)
    out["control"] = judge.act_numbers(adapter, hp, judged["weights"],
                                       judged["obs"], torch.argmax(q, -1))
    return out
  for name, prec, fault in (("control", precision, None),
                            ("half_batch", "float32", "half_batch"),
                            ("altered", "float32", "altered")):
    produced = judge.follow(adapter, hp, judged["weights"],
                            judged["records"], judged["follow_args"], prec,
                            fault=fault)
    out[name] = judge.training_numbers(adapter, hp, judged["weights"],
                                       judged["records"], produced,
                                       judged["follow_args"])
  return out


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--workload", required=True)
  parser.add_argument("--seeds", type=_seeds, required=True)
  parser.add_argument("--controls", type=_seeds, default=[])
  parser.add_argument("--seconds", type=float, default=2.0)
  parser.add_argument("--device", default="cuda")
  args = parser.parse_args(argv)
  sys.path[0] = ROOT   # not this folder: its modules are the harness's
  rows = []
  for seed in dict.fromkeys(args.seeds + args.controls):
    row = readings(args.workload, seed, args.seconds, args.device,
                   seed in args.controls)
    print(json.dumps(row), flush=True)
    rows.append(row)
  summary = {}
  for kind in ("program", "control", "half_batch", "altered"):
    got = [r[kind] for r in rows if kind in r]
    if got:
      pick = max if kind == "program" else min
      summary[kind] = {k: pick(g[k] for g in got) for k in got[0]
                       if not isinstance(got[0][k], list)}
  print(json.dumps({"summary": summary, "program_seeds": len(
      [r for r in rows if r["seed"] in args.seeds])}))


if __name__ == "__main__":
  main()
