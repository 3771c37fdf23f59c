"""Paired chip_smoke readings of two trees on one card in one call.

    python3 orion_tpu_torch/pair_trees.py OTHER_TREE [--paths]

OTHER_TREE is another checkout of this repo (a ``git archive`` of the
parent commit, say).  Runs the ``kernels`` cases of A and A′, of B and
C (train, GQA and ragged shapes) and of the ring chunks (A′, B′, C′)
from each tree's own ``chip_smoke.py`` in the order other, this, this,
other, one process each, all timed by this checkout's
``chip_smoke.time_ms`` (device time from ``torch.profiler``), so the
two trees' kernels are read by one method on one card in one call.
Every case also times its plain version and SDPA, and the kernels a
change did not touch: in trees where those did not change they are
the pairing's control.  With
``--paths``, each run then serves the bf16 engine phase and runs the
GRPO and int8 GRPO phases, and reports their walls.  Prints one JSON
line a run.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLASH = (("pythia_prefill", 8, 512, 640, 8, 8, 256, 1),
         ("llama_gqa", 4, 256, 320, 32, 8, 64, 2),
         ("verify", 8, 5, 388, 8, 8, 256, 3))
BWD = (("pythia_train", 8, 384, 384, 8, 8, 256, None, 6),
       ("llama_gqa", 4, 256, 256, 32, 8, 64, None, 7),
       ("odd_ragged", 4, 389, 397, 8, 8, 256, 8, 8))
CHUNK = (("pythia_ring", 4, 1, 8192, 8, 8, 256, 11),
         ("llama_gqa_ring", 4, 1, 4096, 32, 8, 64, 12))
KEYS = ("ms", "plain_ms", "library_ms", "max_abs_err")


def run_tree(tree: str, paths: bool) -> dict:
    """The A, B/C and ring-chunk cases of ``tree``'s chip_smoke, timed
    here; with ``paths`` its serving and GRPO phases too."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke as cs
    from orion_tpu_torch.ops import cuda_build

    cs.time_ms = here.time_ms
    cuda_build.build()
    card = here.nvidia_smi()
    out = {"tree": tree, "card": card, "flash_fwd": {}, "flash_bwd": {},
           "flash_chunk": {}}
    for case in FLASH:
        res = cs.flash_case(*case)
        out["flash_fwd"][case[0]] = {k: res[k] for k in KEYS}
    for case in BWD:
        res = cs.flash_bwd_case(*case)
        out["flash_bwd"][case[0]] = {
            kname: {k: res[kname][k] for k in KEYS}
            for kname in ("flash_bwd_dq", "flash_bwd_dkv")}
    for case in CHUNK:
        res = cs.chunk_case(*case)
        out["flash_chunk"][case[0]] = {
            kname: {k: res[kname][k] for k in KEYS}
            for kname in ("flash_chunk_fwd", "flash_chunk_bwd_dq",
                          "flash_chunk_bwd_dkv")}
    if paths:
        res = cs.engine_phase(card)
        out["engine"] = {k: res[k]
                         for k in ("wall_s", "tokens_per_s", "ttft_p50_s")}
        for name, phase in (("train", cs.train_phase),
                            ("train_int8", cs.train_int8_phase)):
            res = phase(card)
            out[name] = {k: res[k]
                         for k in ("iteration_wall_s", "samples_per_s")}
            out[name]["rollout_update_s"] = [
                (i["time_rollout_s"], i["time_update_s"])
                for i in res["iterations"]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the other tree's root")
    ap.add_argument("--paths", action="store_true",
                    help="also the serving and GRPO phases' walls")
    ap.add_argument("--one", action="store_true",
                    help="run the tree given, once")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(run_tree(args.other, args.paths)), flush=True)
        return 0
    rc = 0
    for tree in (args.other, HERE, HERE, args.other):
        cmd = [sys.executable, os.path.abspath(__file__), tree, "--one"]
        done = subprocess.run(cmd + (["--paths"] if args.paths else []),
                              timeout=900)
        rc = rc or done.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
