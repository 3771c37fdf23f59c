"""Where the GRPO trainer's time goes on the card.

    python3 -m orion_tpu_torch.profile_train [--seed 0]

Runs the training smoke of :mod:`orion_tpu_torch.smoke` (the work of
``chip_smoke.py``'s train phase): one warm-up iteration, one
unprofiled iteration for the wall times, then one iteration under
``torch.profiler``, its rollout half (generate, score, old and ref
logprobs) and its update half (minibatch forward/backward, AdamW,
weight sync) profiled apart.  Prints JSON lines: the card, the
unprofiled iteration, and for each half the device time by kernel
class, the top kernels and the device idle share (1 - summed kernel
time over wall; the profiler's own host cost lengthens the wall, so
the share is an upper bound).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from orion_tpu_torch.profile_engine import card_name, device_breakdown
    from orion_tpu_torch.smoke import smoke_trainer_and_prompts

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    card = card_name()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)

    _, tr, prompts = smoke_trainer_and_prompts(args.seed)
    tr.train(prompts, num_iterations=2)      # warm-up, then timed
    stats = tr.metrics_history[-1]
    print(json.dumps({"run": "unprofiled", "card": card, **{
        k: stats[k] for k in ("time_rollout_s", "time_update_s",
                              "samples_per_sec", "completion_len_mean")}}),
          flush=True)

    def profiled(name, fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out = device_breakdown(prof, wall)
        print(json.dumps({"run": f"profiled {name}", "card": card, **out}),
              flush=True)
        return result, bool(out["device_busy_ms"])

    (experience, _), ok_rollout = profiled(
        "rollout", lambda: tr.make_experience(next(prompts)))
    _, ok_update = profiled("update", lambda: (
        tr.update_epochs(experience), tr.sync_weights()))
    return 0 if ok_rollout and ok_update else 1


if __name__ == "__main__":
    sys.exit(main())
