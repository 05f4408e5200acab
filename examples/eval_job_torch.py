"""Standalone evaluation job with the PyTorch port: polls exported
policies and evaluates them.

Port of ``examples/eval_job.py``: it waits for a policy export under
``root_dir/policies/greedy_policy``, reloads the params whenever the
manifest's train step changes, and runs `--eval_episodes` episodes on a
host env through `compute`, printing one JSON line per evaluation
(``{"train_step": ..., "AverageReturn": ..., "AverageEpisodeLength":
...}``). Where the JAX job rebuilds a SAC template by hand, this one
rebuilds the policy from the manifest (``load_policy(dir)``), so it
evaluates any self-contained export. `main` takes an env factory, so a
caller without gymnasium can pass a host env; by default the env is
``suite_gym.load(--env_name)``. The policy acts on "cuda" unless
`--device` says otherwise.

Usage (beside a training job that writes policy exports, e.g.
``examples/dqn_cartpole_torch.py --cfg.policy_interval=1000``):
  python examples/eval_job_torch.py --root_dir=runs/dqn_cartpole_torch \\
      --env_name=CartPole-v1 --eval_episodes=5 [--device cpu]
"""
import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def parse_args(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument("--root_dir", required=True)
  parser.add_argument("--env_name", default="HalfCheetah-v5")
  parser.add_argument("--eval_episodes", type=int, default=5)
  parser.add_argument("--poll_secs", type=float, default=5.0)
  parser.add_argument("--max_evals", type=int, default=0,
                      help="stop after N evals (0 = forever)")
  parser.add_argument("--device", default="cuda")
  return parser.parse_args(argv)


class _Batched:
  """A loaded policy on an unbatched host env: a batch of one per call."""

  def __init__(self, loaded):
    self._loaded = loaded

  def action(self, time_step, state=()):
    from agents_tpu_torch.utils import nest_utils

    step = self._loaded.action(nest_utils.batch_nested_array(time_step),
                               state)
    return step.replace(
        action=nest_utils.unbatch_nested_array(step.action))

  def init_state(self, batch_size=None):
    return self._loaded.init_state(1)


def run_eval_job(args, make_env=None, log=print):
  """Evaluate each new export until `args.max_evals` evals (0: forever);
  returns the result lines."""
  from agents_tpu_torch.eval.metric_utils import compute
  from agents_tpu_torch.metrics import py_metrics
  from agents_tpu_torch.policies import policy_saver as ps_lib
  from agents_tpu_torch.train.train_utils import wait_for_policy

  policy_dir = os.path.join(args.root_dir, "policies", "greedy_policy")
  log(json.dumps({"job": "eval", "waiting_for": policy_dir}))
  assert wait_for_policy(policy_dir, sleep_time_secs=args.poll_secs,
                         timeout_secs=None)
  if make_env is None:
    from agents_tpu_torch.environments import suite_gym
    env = suite_gym.load(args.env_name)
  else:
    env = make_env()
  loaded = ps_lib.load_policy(policy_dir, device=args.device)
  policy = loaded if env.batched else _Batched(loaded)

  last_step, out = None, []
  while not args.max_evals or len(out) < args.max_evals:
    manifest = ps_lib.load_manifest(policy_dir)
    if manifest["train_step"] != last_step:
      loaded.update_from_checkpoint()
      last_step = manifest["train_step"]
      metrics = [py_metrics.AverageReturnMetric(args.eval_episodes),
                 py_metrics.AverageEpisodeLengthMetric(args.eval_episodes)]
      results = compute(metrics, env, policy,
                        num_episodes=args.eval_episodes)
      line = {"train_step": last_step,
              **{k: float(v) for k, v in results.items()}}
      log(json.dumps(line))
      out.append(line)
      continue
    time.sleep(args.poll_secs)
  env.close()
  return out


def main(argv=None, make_env=None):
  run_eval_job(parse_args(argv), make_env,
               log=lambda line: print(line, flush=True))


if __name__ == "__main__":
  main()
