"""Design checks of kernels B and B′ (``csrc/flash_bwd_dq.cu``) on the card.

    python3 -m orion_tpu_torch.dq_variants

Builds two variants of the bf16 body from patched copies of the source
(in the git-ignored ``csrc/_build/variants/``) beside the shipped one:

- ``one_rounding``: dS rounded to bf16 once (no ``lo`` product);
- ``no_f64``: the dP of a row that sees one key from the tensor cores.

Each of the three runs every bf16 B and B′ case of
``tests/test_torch_kernels_cuda.py`` (kernel A's O for FLASH, an O apart
from the inputs for DQ_EDGES, the ring chunks of CHUNK), and is held to
the card tests' rule: error against the f32 plain version at most 2x
the bf16 plain version's.  Then the shipped body and ``one_rounding``
are timed in turns (shipped, variant, shipped, variant) at
chip_smoke.py's B shapes by ``chip_smoke.time_ms`` (device time).
Prints one JSON line a case.  Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (text of the shipped source, its replacement)
PATCHES = {
    "one_rounding": ("                wgmma_pv<D>(dq, dl + 4 * kk, dk);\n",
                     ""),
    "no_f64": ("if (t == 0 && __any_sync(", "if (false && __any_sync("),
}
TIMED = (("pythia_train", 8, 384, 384, 8, 8, 256, None, 6),
         ("llama_gqa", 4, 256, 256, 32, 8, 64, None, 7),
         ("odd_ragged", 4, 389, 397, 8, 8, 256, 8, 8))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants() -> dict:
    """{name: ctypes library} for the shipped body and each patch."""
    from orion_tpu_torch.ops import cuda_build

    libs = {"shipped": cuda_build.library("flash_bwd_dq")}
    with open(os.path.join(cuda_build.CSRC, "flash_bwd_dq.cu")) as f:
        src = f.read()
    for name, (old, new) in PATCHES.items():
        if old not in src:
            raise RuntimeError(f"variant {name}: patch target not found")
        d = os.path.join(cuda_build.BUILD_DIR, "variants", name)
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(cuda_build.CSRC, "common.cuh"), d)
        cu = os.path.join(d, "flash_bwd_dq.cu")
        with open(cu, "w") as f:
            f.write(src.replace(old, new))
        so = os.path.join(d, "libflash_bwd_dq.so")
        done = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                               "-o", so, cu], capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n"
                               f"{done.stdout}{done.stderr}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main() -> int:
    import torch

    sys.path.insert(0, HERE)
    from orion_tpu_torch.ops import cuda_build
    from orion_tpu_torch.ops import flash_attention as fa

    cs = _load("chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    T = _load("card_tests", os.path.join(HERE, "tests",
                                         "test_torch_kernels_cuda.py"))
    libs = build_variants()
    bf = torch.bfloat16
    print(json.dumps({"card": cs.nvidia_smi()}), flush=True)

    def each(run):
        """{variant: (err, plain err, within 2x)} for one case."""
        row = {}
        for name, lib in libs.items():
            cuda_build._libs["flash_bwd_dq"] = lib
            got, plain, ref = run()
            ek = (got.float() - ref).abs().max().item()
            ep = (plain.float() - ref).abs().max().item()
            row[name] = {"err": ek, "plain_err": ep, "ok": ek <= 2 * ep}
        cuda_build._libs["flash_bwd_dq"] = libs["shipped"]
        return row

    def dense(q, k, v, pos, out, dout, lse, scale):
        delta = fa.flash_attention_delta(out, dout)
        plain = fa.flash_attention_backward_reference(
            q, k, v, pos, out, lse, dout, scale)[0]
        ref = fa.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), pos, out.float(), lse,
            dout.float(), scale)[0]
        return lambda: (fa.flash_bwd_dq(q, k, v, pos, dout, lse, delta,
                                        scale), plain, ref)

    for shape in T.FLASH:
        q, k, v, pos, dout, out, lse, scale = T._backward_case(shape, bf)
        print(json.dumps({"FLASH": shape[:6], **each(
            dense(q, k, v, pos, out, dout, lse, scale))}), flush=True)
    for shape in T.DQ_EDGES:
        q, k, v, pos, out, dout, lse, scale = T._dq_inputs(
            shape, sum(shape[:6]))
        print(json.dumps({"DQ_EDGES": shape[:6], **each(
            dense(q, k, v, pos, out, dout, lse, scale))}), flush=True)
    for shape in T.CHUNK:
        q, k, v, qpos, kvpos, out, dout, glse, _, scale = T._chunk_case(
            shape, bf)
        delta = fa.flash_attention_delta(out, dout)
        plain = fa.flash_chunk_grads_reference(
            q, k, v, qpos, kvpos, out, glse, dout, scale)[0]
        ref = fa.flash_chunk_grads_reference(
            q.float(), k.float(), v.float(), qpos, kvpos, out.float(), glse,
            dout.float(), scale)[0]
        print(json.dumps({"CHUNK": shape, **each(
            lambda: (fa.flash_chunk_bwd_dq(q, k, v, qpos, kvpos, dout, glse,
                                           delta, scale), plain, ref))}),
              flush=True)
    for case in TIMED:
        row = {}
        for name in ("shipped", "one_rounding") * 2:
            cuda_build._libs["flash_bwd_dq"] = libs[name]
            res = cs.flash_bwd_case(*case)["flash_bwd_dq"]
            row.setdefault(name, []).append(
                {"ms": res["ms"],
                 "err_ratio": res["max_abs_err"] / res["plain_bf16_err"]})
        cuda_build._libs["flash_bwd_dq"] = libs["shipped"]
        print(json.dumps({"timed": case[0], **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
