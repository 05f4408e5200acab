"""One run of one cell of the benchmark of `agents_tpu_torch` on the card.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Run from the root of a checkout. The cell's names in ``BENCHMARK.json``
find its files (`harness.py`). With ``--trace 0`` the last line of
standard output holds the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics; both hold `correct` and, last, each number it was
decided by beside its limit, which the last lines of standard error
repeat. Without a card (or with fewer than the cell asks for), or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits non-zero.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "runs", "portbench_cache")


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--workload", required=True)
  parser.add_argument("--seed", type=int, required=True)
  parser.add_argument("--seconds", type=float, required=True)
  parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = parser.parse_args(argv)
  # Kernel caches stay in the checkout, at fixed paths.
  for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(CACHE, sub)
  sys.path[0] = ROOT   # not this folder: its modules are the harness's

  import torch

  from portbench import harness

  # One process, few threads: the port's work is on the card, its host
  # work on the Python thread.
  torch.set_num_threads(1)

  cell = harness.cell_spec(args.workload)["cell"]
  if not torch.cuda.is_available() or (
      torch.cuda.device_count() < cell["chips"]):
    print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
          "device(s)", file=sys.stderr)
    return 2
  line = harness.run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", t_start=T_START)
  found = harness.forbidden_modules()
  if found:
    print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
    return 3
  for name, check in line["checks"].items():
    print(f"check {name} {check['value']!r} limit {check['limit']!r}",
          file=sys.stderr)
  sys.stderr.flush()
  print(json.dumps(line))
  return 0


if __name__ == "__main__":
  sys.exit(main())
