"""Where the serving engine's time goes on the card.

    python3 -m orion_tpu_torch.profile_engine [--requests 64] [--seed 0]
                                              [--int8]

Serves the smoke mix of :mod:`orion_tpu_torch.smoke` (the workload of
``chip_smoke.py``'s engine phase; with ``--int8`` its int8 twin, the
``engine_int8`` phase's: int8 weights and KV pools) twice: once
unprofiled for the wall time, once under ``torch.profiler`` for the
device time by kernel.  Prints JSON lines: the card, the unprofiled
run, the device-time breakdown by kernel class and the top kernels,
and the device idle share of the profiled run (1 - summed kernel time
over wall; one stream, so kernels do not overlap; the profiler's own
host cost lengthens the profiled wall, so this share is an upper
bound).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

# Kernel-name classes, first match wins.
CLASSES = (
    ("flash_chunk_fwd", r"flash_fwd_(wgmma_)?kernel<.*true>"),
    ("flash_chunk_bwd_dq", r"flash_bwd_dq_kernel<.*true>"),
    ("flash_chunk_bwd_dkv", r"flash_bwd_dkv_kernel<.*true>"),
    ("flash_fwd", r"flash_fwd_(wgmma_)?kernel"),
    ("flash_bwd_dq", r"flash_bwd_dq_kernel"),
    ("flash_bwd_dkv", r"flash_bwd_dkv_kernel"),
    ("paged_decode_int8", r"paged_decode_kernel<.*true>"),
    ("paged_decode", r"paged_decode_kernel"),
    ("optimizer", r"multi_tensor_apply"),
    ("matmul", r"gemm|gemv|sm90_|cutlass|cublas|nvjet|splitK"),
    ("sort_topk_reduce", r"[Rr]educe|[Ss]oftmax|argmax|[Ss]ort|topk"),
    ("index_scatter_gather", r"[Ii]ndex|[Ss]catter|[Gg]ather"),
    ("copy_cast", r"[Cc]opy|[Cc]ast|memcpy|memset|Memcpy|Memset"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def _serve(eng, reqs) -> tuple:
    import torch

    eng.reset_rng(0)
    t0 = time.perf_counter()
    for rid, ids, budget in reqs:
        eng.submit(rid, ids, budget=budget)
    n = 0
    while eng.pending:
        n += sum(len(r.tokens) for r in eng.step())
    torch.cuda.synchronize()
    return time.perf_counter() - t0, n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--int8", action="store_true",
                    help="the int8 serving mix (int8 weights and KV pools)")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from orion_tpu_torch.smoke import smoke_engine_and_requests

    if not torch.cuda.is_available():
        print("profile_engine: no CUDA device", file=sys.stderr)
        return 1
    card = card_name()
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "int8": args.int8}), flush=True)

    _, _, eng, reqs = smoke_engine_and_requests(args.requests, args.seed,
                                                int8=args.int8)

    wall, tokens = _serve(eng, reqs)
    print(json.dumps({"run": "unprofiled", "card": card, "int8": args.int8,
                      "wall_s": wall,
                      "generated_tokens": tokens,
                      "tokens_per_s": tokens / wall}), flush=True)

    reqs = [(rid + 1000, ids, b) for rid, ids, b in reqs]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pwall, _ = _serve(eng, reqs)
    out = device_breakdown(prof, pwall)
    print(json.dumps({"run": "profiled", "card": card, "int8": args.int8,
                      **out}), flush=True)
    return 0 if out["device_busy_ms"] else 1


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def device_breakdown(prof, wall_s: float) -> dict:
    """Device time by kernel class and the top kernels of a finished
    ``torch.profiler`` run, and its device idle share against
    ``wall_s`` (one stream, so kernels do not overlap)."""
    from torch.autograd import DeviceType

    by_class: dict = {}
    kernels = []
    for ev in prof.key_averages():
        # Kernel events only: an operator's entry, or a user annotation
        # such as the optimizer's ``Optimizer.step#AdamW.step`` range on
        # the device, would count its kernels' time a second time.
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        dev_us = max(getattr(ev, "device_time_total", 0),
                     getattr(ev, "self_device_time_total", 0))
        if dev_us <= 0:
            continue
        cls = next((c for c, pat in CLASSES if re.search(pat, ev.key)),
                   "other")
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
        kernels.append((dev_us / 1e3, ev.count, ev.key[:90]))
    busy_ms = sum(by_class.values())
    kernels.sort(reverse=True)
    return {
        "wall_s": wall_s,
        "device_busy_ms": busy_ms if busy_ms else None,
        "device_idle_share": (1 - busy_ms / 1e3 / wall_s) if busy_ms
        else None,
        "by_class_ms": dict(sorted(by_class.items(),
                                   key=lambda kv: -kv[1])),
        "top_kernels": [{"ms": ms, "calls": n, "name": name}
                        for ms, n, name in kernels[:15]]}


if __name__ == "__main__":
    sys.exit(main())
