"""Where the long-context training step's time goes on the card.

    python3 -m orion_tpu_torch.profile_longctx [--seed 0]

Runs the long-context mix of :mod:`orion_tpu_torch.smoke` (the work of
``chip_smoke.py``'s longctx phase): one loss and backward over 8,192
tokens, sequence parallel on a ring of 4 (kernels A′, B′, C′), and the
same step dense (kernels A, B, C) on the same weights.  Each step runs
once to warm up, once unprofiled for its wall, then once under
``torch.profiler``.  Prints JSON lines: the card, each step's
unprofiled wall and peak memory, and for each profiled step the device
time by kernel class, the top kernels and the device idle share (1 -
summed kernel time over wall; the profiler's own host cost lengthens
the wall, so the share is an upper bound).  Needs a CUDA card.
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
    from orion_tpu_torch.smoke import longctx_loss, smoke_longctx

    if not torch.cuda.is_available():
        print("profile_longctx: no CUDA device", file=sys.stderr)
        return 1
    card = card_name()
    print(json.dumps({"card": card, "torch": torch.__version__}),
          flush=True)
    _, model, dense, ids, tgt, ring = smoke_longctx(args.seed)
    steps = {"ring": (model, ring), "dense": (dense, None)}

    def step(name):
        m, r = steps[name]
        loss = longctx_loss(m, ids, tgt, r)
        torch.autograd.grad(loss, list(m.parameters()))
        torch.cuda.synchronize()

    ok = True
    for name in steps:
        step(name)                                  # warm-up
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(name)
        wall = time.perf_counter() - t0
        print(json.dumps({"run": f"unprofiled {name}", "card": card,
                          "wall_s": wall, "peak_mem_gb":
                          torch.cuda.max_memory_allocated() / 1e9}),
              flush=True)
    for name in steps:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(name)
            wall = time.perf_counter() - t0
        out = device_breakdown(prof, wall)
        print(json.dumps({"run": f"profiled {name}", "card": card, **out}),
              flush=True)
        ok = ok and bool(out["device_busy_ms"])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
