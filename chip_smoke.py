#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``orion_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels), ``nvcc`` and
``g++``; builds everything it runs from the checkout.  Phases, each
printing one JSON line:

1. ``device``  — the card's name and power limit (``nvidia-smi``).
2. ``build``   — the CUDA kernels (one ``nvcc`` per source, all started
   together) and the native page scheduler, with their build seconds
   and each kernel instance's registers and spills (``-Xptxas -v``);
   a tensor-core (``wgmma``) instance that spills fails it.
3. ``kernels`` — each kernel against its plain PyTorch version on the
   card (bf16 queries; bf16 pools for D, int8 pools for D') at the
   serving, training and long-context slices' shapes, with device
   times (``torch.profiler``) and bounds; the ring chunks A', B' and
   C' at zigzag positions after one rotation, so that some tiles and
   rows have no valid key.
4. ``engine``  — the continuous-batching engine at Pythia-1B width
   (random seeded weights, bf16) serves 64 greedy requests; kernels A
   and D launch exactly as often as the waves and steps imply; 4
   completions are re-scored by a full forward with the plain
   attention.
5. ``engine_int8`` — the same 64 requests with int8 weights and int8 KV
   pools: A launches once per layer and prefill wave, D' once per layer
   and decode step, D never; 4 completions are re-scored by the same
   quantized model with the plain attention through a fresh int8 paged
   cache.
6. ``train``   — the GRPO trainer at Pythia-1B width and full depth
   (f32 master weights from a seed, bf16 compute, group prefix sharing)
   runs 2 iterations of 32 rollouts; gradients through kernels A, B and
   C agree with the plain attention's before the first step, every loss
   and gradient norm is finite, the importance ratio starts at 1, the
   kernel launch counts are those the code implies, and the engine's
   weights equal the policy's cast to bf16 after the weight sync.
7. ``train_int8`` — one GRPO iteration with the int8 rollout: D' is
   launched (D never), the ratio starts at 1, and after the sync the
   engine's int8 weights and scales equal ``prep_decode_params`` of the
   policy, bitwise.
8. ``longctx`` — one training step of a Pythia-1B-width model at full
   depth (f32 master weights from a seed, bf16 compute) on an 8,192-token
   sequence, sequence parallel over a ring of 4 shards in zigzag layout
   (``attention_impl="ring"``: kernels A', B' and C', 64 launches each),
   against the same step dense (kernels A, B and C, 16 each): losses
   within LONGCTX_LOSS_ATOL, every parameter's gradient in direction
   and size as the train phase holds them (the k_proj bias on its
   rotary dims, where its exact gradient is not 0); then one AdamW step
   from the ring's gradients leaves every parameter finite.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line,
and as the last line ``{"ok": true, "device": {...}}``.  Any failed
check exits non-zero before that line.  Without a CUDA device, or
without the ``orion_tpu_torch`` package beside this file, it exits 1
and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Card peaks for the bound (NVIDIA H100 SXM data sheet, dense).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Kernel vs plain: both compute in f32 from the same bf16 inputs, so
# only the kernel's summation order and its rounding of O to bf16
# differ.  Against an f32 evaluation of the plain version, the bf16
# kernel may be at most this factor worse than the bf16 plain version
# (a result one bf16 ulp away instead of half an ulp).
ERR_FACTOR = 2.0
# LSE is f32 in both: summation order only (up to 640 terms).
LSE_TOL = 1e-3
# Train phase.  Gradients through kernels A/B/C against the same model
# with the plain attention, both in bf16 compute: the two attentions
# round differently, so the gradients agree in direction and size, not
# bitwise.
GRAD_COS_MIN = 0.99
GRAD_NORM_RTOL = 0.05
# Sync mode recomputes the old logprobs under the policy, so at each
# iteration's first minibatch (no step taken yet) the ratio is 1 up to
# rounding.  The recomputation runs the batch of 32 and the update the
# minibatch of 8; old_logprob_gap holds the same 8 rows recomputed at
# batch 8 against it, to tell a rounding gap from a fault.  Later
# minibatches follow the updates, so only the first one is checked.
RATIO_TOL = 0.01
CLIP_FRAC_MAX = 1e-3
# Re-scoring: where the plain-attention forward's top-2 logit margin
# exceeds this, the engine's greedy token must be its argmax.  The two
# forwards differ only by bf16 rounding (measured per position as the
# engine-vs-plain policy logprob gap, printed beside it); in the int8
# phase both sides read the same int8 weights and the same int8 KV.
MARGIN = 0.25
# Long-context phase: the ring and the dense step compute one loss in
# bf16 through different kernels and merge orders.
LONGCTX_LOSS_ATOL = 1e-2


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the durations of the CUDA
    kernels and copies that ``reps`` calls launch, from a
    ``torch.profiler`` trace, summed and divided by ``reps``.  The
    host's time between launches (Python, a wrapper's checks) is not in
    it, so at small shapes it reads the kernels, not the caller."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # Kernel and copy events only: an operator's entry would count its
    # kernels' time a second time.
    us = sum(max(getattr(ev, "device_time_total", 0),
                 getattr(ev, "self_device_time_total", 0))
             for ev in prof.key_averages()
             if ev.device_type == DeviceType.CUDA
             and not getattr(ev, "is_user_annotation", False))
    check(us > 0, "time_ms: the profiler recorded no device time")
    return us / 1e3 / reps


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# -- phase 3: kernels against their plain versions -----------------------

def flash_case(name, B, Lq, Lk, H, Hkv, D, seed):
    import torch
    import torch.nn.functional as F

    from orion_tpu_torch.ops.flash_attention import (
        flash_attention_gqa, flash_attention_reference)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dev, bf = "cuda", torch.bfloat16
    q = torch.randn(B, Lq, H, D, generator=gen, device=dev).to(bf)
    k = torch.randn(B, Lk, Hkv, D, generator=gen, device=dev).to(bf)
    v = torch.randn(B, Lk, Hkv, D, generator=gen, device=dev).to(bf)
    # Ragged rows: each row's positions start at its own offset (the
    # chunked/verify layout), run right-padded past any prompt, and the
    # frontier differs per row.
    offs = torch.randint(0, Lk - Lq + 1, (B, 1), generator=gen, device=dev)
    pos = (offs + torch.arange(Lq, device=dev)[None, :]).to(torch.int32)
    scale = 1.0 / D ** 0.5

    out_k, lse_k = flash_attention_gqa(q, k, v, pos, scale, return_lse=True)
    torch.cuda.synchronize()
    out_p = flash_attention_reference(q, k, v, pos, scale)
    ref, lse_r = flash_attention_reference(q.float(), k.float(), v.float(),
                                           pos, scale, return_lse=True)
    err_k = (out_k.float() - ref).abs().max().item()
    err_p = (out_p.float() - ref).abs().max().item()
    err_lse = (lse_k - lse_r).abs().max().item()
    check(bool(torch.isfinite(out_k).all()), f"flash {name}: non-finite")
    check(err_k <= ERR_FACTOR * err_p,
          f"flash {name}: kernel err {err_k} > {ERR_FACTOR} x plain "
          f"err {err_p}")
    check(err_lse <= LSE_TOL, f"flash {name}: lse err {err_lse}")

    ms = time_ms(lambda: flash_attention_gqa(q, k, v, pos, scale))
    plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, pos,
                                                         scale), reps=5)
    # Yardstick only (the port never calls it): one library call
    # computing the same function on the same inputs.
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (torch.arange(Lk, device=dev)[None, None, :]
            <= pos[:, :, None])[:, None]
    gqa = {"enable_gqa": True} if H != Hkv else {}
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=scale, **gqa))

    # Bound, counting only what this data needs: q and positions read
    # once; of K and V, row b's slots up to its frontier max(pos_b) + 1
    # (slots past it are never needed); O and LSE written once; flops
    # for the valid (query, key) pairs only.
    kv_rows = torch.clamp(pos.long().amax(dim=1) + 1, 0, Lk).sum().item()
    nbytes = 2 * (q.numel() + out_k.numel() + 2 * kv_rows * Hkv * D) \
        + 4 * (pos.numel() + lse_k.numel())
    valid_pairs = torch.clamp(pos.long() + 1, max=Lk).sum().item() * H
    flops = 4.0 * D * valid_pairs
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    return {"case": name, "shape": {"B": B, "Lq": Lq, "Lk": Lk, "H": H,
                                    "Hkv": Hkv, "D": D},
            "max_abs_err": err_k, "plain_bf16_err": err_p,
            "lse_err": err_lse, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bms, "bound_by": by}


def paged_case(name, B, H, Hkv, D, ps, max_pages, seed):
    import torch

    from orion_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dev, bf = "cuda", torch.bfloat16
    n_pages = B * max_pages + 1
    q = torch.randn(B, H, D, generator=gen, device=dev).to(bf)
    kp = torch.randn(n_pages, Hkv, ps, D, generator=gen, device=dev).to(bf)
    vp = torch.randn(n_pages, Hkv, ps, D, generator=gen, device=dev).to(bf)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = perm[:B * max_pages].reshape(B, max_pages).to(torch.int32)
    lens = torch.randint(1, ps * max_pages + 1, (B,), generator=gen,
                         device=dev).to(torch.int32)
    lens[0] = 1                        # a single-token sequence
    lens[1] = ps * max_pages           # a full table
    # Padding pages: table entries past each row's last page in use
    # point at page 0, whose content must never count.
    used = (lens + ps - 1) // ps
    col = torch.arange(max_pages, device=dev)[None, :]
    bt = torch.where(col < used[:, None], bt, torch.zeros_like(bt))
    scale = 1.0 / D ** 0.5

    out_k = paged_decode_attention(q, kp, vp, bt, lens, scale)
    torch.cuda.synchronize()
    out_p = paged_decode_attention_reference(q, kp, vp, bt, lens, scale)
    ref = paged_decode_attention_reference(q.float(), kp.float(),
                                           vp.float(), bt, lens, scale)
    err_k = (out_k.float() - ref).abs().max().item()
    err_p = (out_p.float() - ref).abs().max().item()
    check(bool(torch.isfinite(out_k).all()), f"paged {name}: non-finite")
    check(err_k <= ERR_FACTOR * err_p,
          f"paged {name}: kernel err {err_k} > {ERR_FACTOR} x plain "
          f"err {err_p}")

    ms = time_ms(lambda: paged_decode_attention(q, kp, vp, bt, lens,
                                                scale))
    plain_ms = time_ms(lambda: paged_decode_attention_reference(
        q, kp, vp, bt, lens, scale), reps=5)
    tokens = lens.long().sum().item()
    nbytes = (2 * 2 * tokens * Hkv * D + 2 * 2 * q.numel()
              + 4 * (used.sum().item() + B))
    flops = 4.0 * D * H * tokens
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    return {"case": name, "shape": {"B": B, "H": H, "Hkv": Hkv, "D": D,
                                    "ps": ps, "max_pages": max_pages},
            "max_abs_err": err_k, "plain_bf16_err": err_p, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bms,
            "bound_by": by}


def paged_int8_case(name, B, H, Hkv, D, ps, max_pages, seed):
    """Kernel D' against its plain version: bf16 q over int8 pools made
    by quantizing random bf16 K and V per (token, head), as the engine
    writes them."""
    import torch

    from orion_tpu_torch.ops.paged_attention import (
        paged_decode_attention_int8, paged_decode_attention_reference)
    from orion_tpu_torch.ops.quant import quantize_kv

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dev, bf = "cuda", torch.bfloat16
    n_pages = B * max_pages + 1
    q = torch.randn(B, H, D, generator=gen, device=dev).to(bf)
    pools = []
    for _ in range(2):
        x = torch.randn(n_pages, Hkv, ps, D, generator=gen,
                        device=dev).to(bf)
        xq, xs = quantize_kv(x)                  # [N,Hkv,ps,D], [N,Hkv,ps]
        pools += [xq, xs[:, :, None, :].contiguous()]
    kp, ks, vp, vs = pools
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
    bt = perm[:B * max_pages].reshape(B, max_pages).to(torch.int32)
    lens = torch.randint(1, ps * max_pages + 1, (B,), generator=gen,
                         device=dev).to(torch.int32)
    lens[0] = 1                        # a single-token sequence
    lens[1] = ps * max_pages           # a full table
    used = (lens + ps - 1) // ps
    col = torch.arange(max_pages, device=dev)[None, :]
    bt = torch.where(col < used[:, None], bt, torch.zeros_like(bt))
    scale = 1.0 / D ** 0.5

    def kernel():
        return paged_decode_attention_int8(q, kp, vp, ks, vs, bt, lens,
                                           scale)

    def plain(qq):
        return paged_decode_attention_reference(qq, kp, vp, bt, lens, scale,
                                                k_scales=ks, v_scales=vs)

    out_k = kernel()
    torch.cuda.synchronize()
    out_p = plain(q)
    ref = plain(q.float())
    err_k = (out_k.float() - ref).abs().max().item()
    err_p = (out_p.float() - ref).abs().max().item()
    check(bool(torch.isfinite(out_k).all()), f"paged_int8 {name}: "
          "non-finite")
    check(err_k <= ERR_FACTOR * err_p,
          f"paged_int8 {name}: kernel err {err_k} > {ERR_FACTOR} x plain "
          f"err {err_p}")

    ms = time_ms(kernel)
    plain_ms = time_ms(lambda: plain(q), reps=5)
    # Bound: every valid K and V row read once at 1 byte an element, 4
    # bytes of scale a slot and kv head for each of K and V, q and O
    # (bf16), the table entries in use and the lengths.
    tokens = lens.long().sum().item()
    nbytes = (2 * tokens * Hkv * D + 2 * 4 * tokens * Hkv
              + 2 * 2 * q.numel() + 4 * (used.sum().item() + B))
    flops = 4.0 * D * H * tokens
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    return {"case": name, "shape": {"B": B, "H": H, "Hkv": Hkv, "D": D,
                                    "ps": ps, "max_pages": max_pages,
                                    "pools": "int8"},
            "max_abs_err": err_k, "plain_bf16_err": err_p, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bms,
            "bound_by": by}


def flash_bwd_case(name, B, Lq, Lk, H, Hkv, D, offsets, seed):
    """Kernels B (dq) and C (dk, dv) against the plain backward on kernel
    A's O and LSE, bf16.  ``offsets`` None means positions arange(Lq)
    (the training layout, Lq == Lk)."""
    import torch
    import torch.nn.functional as F

    from orion_tpu_torch.ops.flash_attention import (
        flash_attention_backward_reference, flash_attention_delta,
        flash_attention_gqa, flash_bwd_dkv, flash_bwd_dq)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dev, bf = "cuda", torch.bfloat16
    q, k, v, dout = (torch.randn(*s, generator=gen, device=dev).to(bf)
                     for s in ((B, Lq, H, D), (B, Lk, Hkv, D),
                               (B, Lk, Hkv, D), (B, Lq, H, D)))
    if offsets is None:
        offs = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    else:
        offs = torch.randint(0, offsets + 1, (B, 1), generator=gen,
                             device=dev)
    pos = (offs + torch.arange(Lq, device=dev)[None, :]).to(torch.int32)
    scale = 1.0 / D ** 0.5
    out, lse = flash_attention_gqa(q, k, v, pos, scale, return_lse=True)
    delta = flash_attention_delta(out, dout)

    def kernels():
        return (flash_bwd_dq(q, k, v, pos, dout, lse, delta, scale),
                *flash_bwd_dkv(q, k, v, pos, dout, lse, delta, scale))

    got = kernels()
    torch.cuda.synchronize()
    plain = flash_attention_backward_reference(q, k, v, pos, out, lse, dout,
                                               scale)
    ref = flash_attention_backward_reference(
        q.float(), k.float(), v.float(), pos, out.float(), lse,
        dout.float(), scale)
    errs = {}
    for which, g, pl, rf in zip(("dq", "dk", "dv"), got, plain, ref):
        err_k = (g.float() - rf).abs().max().item()
        err_p = (pl.float() - rf).abs().max().item()
        check(bool(torch.isfinite(g).all()), f"{which} {name}: non-finite")
        check(err_k <= ERR_FACTOR * err_p,
              f"{which} {name}: kernel err {err_k} > {ERR_FACTOR} x plain "
              f"err {err_p}")
        errs[which] = (err_k, err_p)

    dq_ms = time_ms(lambda: flash_bwd_dq(q, k, v, pos, dout, lse, delta,
                                         scale))
    dkv_ms = time_ms(lambda: flash_bwd_dkv(q, k, v, pos, dout, lse, delta,
                                           scale))
    # The plain version computes dq, dk and dv in one pass.
    plain_ms = time_ms(lambda: flash_attention_backward_reference(
        q, k, v, pos, out, lse, dout, scale), reps=5)
    # Yardstick only (the port never calls it): the backward of one SDPA
    # call on the same inputs (dq, dk and dv together), timed on a
    # retained graph.
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    gqa = {"enable_gqa": True} if H != Hkv else {}
    if offsets is None:
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                            scale=scale, **gqa)
    else:
        mask = (torch.arange(Lk, device=dev)[None, None, :]
                <= pos[:, :, None])[:, None]
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                            scale=scale, **gqa)
    dot = dout.transpose(1, 2).contiguous()
    lib_ms = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                 retain_graph=True))

    # Bounds, counting what this data needs: q, dO, LSE, delta and the
    # positions read once; of K and V only each row's slots up to its
    # frontier max(pos_b) + 1; each output written once; flops for the
    # valid (query, key) pairs only — B does 3 products of 2·D flops
    # per pair and head, C does 4.
    kv_rows = torch.clamp(pos.long().amax(dim=1) + 1, 0, Lk).sum().item()
    pairs = torch.clamp(pos.long() + 1, 0, Lk).sum().item() * H
    common = (2 * (q.numel() + dout.numel() + 2 * kv_rows * Hkv * D)
              + 4 * (lse.numel() + delta.numel() + pos.numel()))
    dq_bound = bound_ms(common + 2 * q.numel(), 6.0 * D * pairs,
                        "bfloat16")
    dkv_bound = bound_ms(common + 2 * 2 * k.numel(), 8.0 * D * pairs,
                         "bfloat16")
    shape = {"B": B, "Lq": Lq, "Lk": Lk, "H": H, "Hkv": Hkv, "D": D}
    return {
        "case": name, "shape": shape,
        "flash_bwd_dq": {
            "max_abs_err": errs["dq"][0], "plain_bf16_err": errs["dq"][1],
            "ms": dq_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": dq_bound[0], "bound_by": dq_bound[1]},
        "flash_bwd_dkv": {
            "max_abs_err": max(errs["dk"][0], errs["dv"][0]),
            "plain_bf16_err": max(errs["dk"][1], errs["dv"][1]),
            "dk_err": errs["dk"][0], "dv_err": errs["dv"][0],
            "ms": dkv_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1]}}


def _pair_counts(qpos, kvpos):
    """Per row of [B, Lq] query and [B, Lk] key positions: the number of
    (query, key) pairs with kv position <= q position, and the number
    of keys valid for at least one query."""
    import torch

    kv_sorted = kvpos.long().sort(dim=1).values
    per_query = torch.searchsorted(kv_sorted, qpos.long(), right=True)
    keys = (kvpos.long() <= qpos.long().amax(dim=1, keepdim=True)).sum()
    return per_query.sum().item(), keys.item()


def chunk_case(name, S, B, L, H, Hkv, D, seed):
    """Kernels A' (forward), B' (dq) and C' (dk, dv) against their plain
    versions on one ring chunk, bf16: S ranks of B rows stacked
    rank-major, each rank's queries at its zigzag positions of an
    L-token sequence and its keys those of rank - 1 (after one
    rotation), so some tiles and rows see no key.  The backward takes
    the global O and LSE over the whole sequence's keys (a plain f32
    evaluation) and a random dO."""
    import torch
    import torch.nn.functional as F

    from orion_tpu_torch.ops.flash_attention import (
        flash_attention_delta, flash_chunk_bwd_dkv, flash_chunk_bwd_dq,
        flash_chunk_fwd, flash_chunk_fwd_reference,
        flash_chunk_grads_reference)
    from orion_tpu_torch.parallel import StackedRing

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dev, bf = "cuda", torch.bfloat16
    ring = StackedRing(S)
    Ls = L // S
    q, k, v, dout = (torch.randn(*s, generator=gen, device=dev).to(bf)
                     for s in ((S * B, Ls, H, D), (S * B, Ls, Hkv, D),
                               (S * B, Ls, Hkv, D), (S * B, Ls, H, D)))
    pos = ring.shard(torch.arange(L, device=dev)[None].expand(B, L))
    qpos = pos.to(torch.int32)
    kvpos = ring.rotate(qpos)
    scale = 1.0 / D ** 0.5
    has_key = (kvpos[:, None, :] <= qpos[:, :, None]).any(-1)

    out_k, lse_k = flash_chunk_fwd(q, k, v, qpos, kvpos, scale)
    torch.cuda.synchronize()
    out_p, _ = flash_chunk_fwd_reference(q, k, v, qpos, kvpos, scale)
    ref, lse_r = flash_chunk_fwd_reference(q.float(), k.float(), v.float(),
                                           qpos, kvpos, scale)
    err_k = (out_k.float() - ref)[has_key].abs().max().item()
    err_p = (out_p.float() - ref)[has_key].abs().max().item()
    lse_rows, lse_ref_rows = lse_k.transpose(1, 2), lse_r.transpose(1, 2)
    err_lse = (lse_rows - lse_ref_rows)[has_key].abs().max().item()
    check(bool(torch.isfinite(out_k).all()), f"chunk {name}: non-finite")
    check(err_k <= ERR_FACTOR * err_p,
          f"chunk {name}: kernel err {err_k} > {ERR_FACTOR} x plain "
          f"err {err_p}")
    check(err_lse <= LSE_TOL, f"chunk {name}: lse err {err_lse}")
    check(bool((out_k[~has_key] == 0).all())
          and bool((lse_rows[~has_key] <= -1e29).all())
          and not bool(has_key.all()),
          f"chunk {name}: rows without a key must give O = 0 and "
          f"LSE <= -1e29 ({int((~has_key).sum())} such rows)")

    # Global O and LSE: each rank's queries against every key of its
    # sequence, evaluated in f32 by the plain version.
    k_all, v_all = (ring.unshard(x, zigzag=False).repeat(S, 1, 1, 1)
                    for x in (k, v))
    kv_all = ring.unshard(qpos, zigzag=False).repeat(S, 1)
    out_g, glse = flash_chunk_fwd_reference(q.float(), k_all.float(),
                                            v_all.float(), qpos, kv_all,
                                            scale)
    del k_all, v_all
    out_g = out_g.to(bf)
    delta = flash_attention_delta(out_g, dout)

    def bwd_kernels():
        return (flash_chunk_bwd_dq(q, k, v, qpos, kvpos, dout, glse, delta,
                                   scale),
                *flash_chunk_bwd_dkv(q, k, v, qpos, kvpos, dout, glse, delta,
                                     scale))

    got = bwd_kernels()
    torch.cuda.synchronize()
    plain = flash_chunk_grads_reference(q, k, v, qpos, kvpos, out_g, glse,
                                        dout, scale)
    refb = flash_chunk_grads_reference(q.float(), k.float(), v.float(), qpos,
                                       kvpos, out_g.float(), glse,
                                       dout.float(), scale)
    errs = {}
    for which, g, pl, rf in zip(("dq", "dk", "dv"), got, plain, refb):
        e_k = (g.float() - rf).abs().max().item()
        e_p = (pl.float() - rf).abs().max().item()
        check(bool(torch.isfinite(g).all()), f"{which} {name}: non-finite")
        check(e_k <= ERR_FACTOR * e_p,
              f"{which} {name}: kernel err {e_k} > {ERR_FACTOR} x plain "
              f"err {e_p}")
        errs[which] = (e_k, e_p)
    check(bool((got[0][~has_key] == 0).all()),
          f"dq {name}: rows without a key must give dQ = 0")

    ms = time_ms(lambda: flash_chunk_fwd(q, k, v, qpos, kvpos, scale))
    plain_ms = time_ms(lambda: flash_chunk_fwd_reference(
        q, k, v, qpos, kvpos, scale), reps=5)
    dq_ms = time_ms(lambda: flash_chunk_bwd_dq(q, k, v, qpos, kvpos, dout,
                                               glse, delta, scale))
    dkv_ms = time_ms(lambda: flash_chunk_bwd_dkv(q, k, v, qpos, kvpos, dout,
                                                 glse, delta, scale))
    bwd_plain_ms = time_ms(lambda: flash_chunk_grads_reference(
        q, k, v, qpos, kvpos, out_g, glse, dout, scale), reps=5)
    # Yardstick only (the port never calls it): one SDPA call with a
    # boolean mask built from the positions, and its backward (dq, dk
    # and dv together) on a retained graph.  Rows without a key give
    # NaN there; only the time is kept.
    mask = (kvpos[:, None, :] <= qpos[:, :, None])[:, None]
    gqa = {"enable_gqa": True} if H != Hkv else {}
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=scale, **gqa))
    ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                        scale=scale, **gqa)
    dot = dout.transpose(1, 2).contiguous()
    lib_bwd_ms = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                     retain_graph=True))

    # Bounds, counting what this data needs: q (and dO, LSE, delta) and
    # both position arrays read once; of K and V only the keys valid for
    # some query of their row; each output written once; flops for the
    # valid (query, key) pairs only (A' 2, B' 3, C' 4 products of 2·D
    # flops per pair and head).
    pairs, kv_rows = _pair_counts(qpos, kvpos)
    pairs *= H
    kv_bytes = 2 * 2 * kv_rows * Hkv * D
    pos_bytes = 4 * (qpos.numel() + kvpos.numel())
    fwd_bound = bound_ms(2 * (q.numel() + out_k.numel()) + kv_bytes
                         + pos_bytes + 4 * lse_k.numel(), 4.0 * D * pairs,
                         "bfloat16")
    common = (2 * (q.numel() + dout.numel()) + kv_bytes + pos_bytes
              + 4 * (glse.numel() + delta.numel()))
    dq_bound = bound_ms(common + 2 * q.numel(), 6.0 * D * pairs, "bfloat16")
    dkv_bound = bound_ms(common + 2 * 2 * k.numel(), 8.0 * D * pairs,
                         "bfloat16")
    shape = {"S": S, "B": B, "L": L, "Lq": Ls, "Lk": Ls, "H": H, "Hkv": Hkv,
             "D": D, "rows_without_key": int((~has_key).sum()),
             "valid_pairs": pairs}
    return {
        "case": name, "shape": shape,
        "flash_chunk_fwd": {
            "max_abs_err": err_k, "plain_bf16_err": err_p,
            "lse_err": err_lse, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": fwd_bound[0],
            "bound_by": fwd_bound[1]},
        "flash_chunk_bwd_dq": {
            "max_abs_err": errs["dq"][0], "plain_bf16_err": errs["dq"][1],
            "ms": dq_ms, "plain_ms": bwd_plain_ms, "library_ms": lib_bwd_ms,
            "bound_ms": dq_bound[0], "bound_by": dq_bound[1]},
        "flash_chunk_bwd_dkv": {
            "max_abs_err": max(errs["dk"][0], errs["dv"][0]),
            "plain_bf16_err": max(errs["dk"][1], errs["dv"][1]),
            "dk_err": errs["dk"][0], "dv_err": errs["dv"][0],
            "ms": dkv_ms, "plain_ms": bwd_plain_ms,
            "library_ms": lib_bwd_ms, "bound_ms": dkv_bound[0],
            "bound_by": dkv_bound[1]}}


# -- phases 4 and 5: the engine at Pythia-1B width, bf16 and int8 --------

def rescore_model(cfg, eng, int8: bool):
    """The engine's weights in a model with the plain (reference)
    attention: the bf16 model, or with ``int8`` the same quantized one."""
    import dataclasses

    from orion_tpu_torch.models import Transformer

    model = Transformer(dataclasses.replace(
        cfg, attention_impl="reference", quantize_dense=int8), device="cuda")
    model.load_state_dict(eng.model.state_dict())
    return model


def engine_phase(card: str, int8: bool = False) -> dict:
    import numpy as np
    import torch

    from orion_tpu_torch.ops.flash_attention import flash_attention_gqa
    from orion_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_int8)
    from orion_tpu_torch.ops.paged_kv import init_paged_cache
    from orion_tpu_torch.smoke import EOS, smoke_engine_and_requests

    phase = "engine_int8" if int8 else "engine"
    # Warmed up inside, outside the counted run.
    cfg, model, eng, reqs = smoke_engine_and_requests(64, seed=0, int8=int8)
    del model   # the engine holds its own weights (an int8 twin)
    torch.cuda.empty_cache()

    prefill0, decode0 = eng.prefill_forwards, eng.decode_steps
    flash_attention_gqa.launches = 0
    paged_decode_attention.launches = 0
    paged_decode_attention_int8.launches = 0
    torch.cuda.reset_peak_memory_stats()
    eng.reset_rng(0)
    t0 = time.perf_counter()
    for rid, ids, budget in reqs:
        eng.submit(rid, ids, budget=budget)
    done = {}
    waves = 0
    while eng.pending:
        for r in eng.step():
            done[r.req_id] = r
        waves += 1
        check(waves < 10000, f"{phase}: no progress")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention_gqa.launches,
                "paged_decode": paged_decode_attention.launches,
                "paged_decode_int8": paged_decode_attention_int8.launches}

    check(sorted(done) == list(range(64)), f"{phase}: missing completions")
    n_tokens = 0
    for rid, ids, budget in reqs:
        r = done[rid]
        n = len(r.tokens)
        n_tokens += n
        check(1 <= n <= budget, f"{phase}: req {rid} length {n} > {budget}")
        check(n == budget or r.tokens[-1] == EOS,
              f"{phase}: req {rid} stopped early without EOS")
        check(bool(np.isfinite(r.logprobs).all()),
              f"{phase}: req {rid} non-finite logprobs")
    # Per layer, A once for each prefill wave (every prompt has 64+
    # tokens) and D (bf16 pools) or D' (int8 pools) once for each
    # decode step; the other decode kernel never.
    L = cfg.num_layers
    prefills = eng.prefill_forwards - prefill0
    decodes = eng.decode_steps - decode0
    decode = "paged_decode_int8" if int8 else "paged_decode"
    expect = {"flash_fwd": L * prefills, "paged_decode": 0,
              "paged_decode_int8": 0}
    expect[decode] = L * decodes
    check(launches == expect and prefills > 0 and decodes > 0,
          f"{phase}: launches {launches}, expected {expect} ({prefills} "
          f"prefill waves, {decodes} decode steps)")

    # Re-score 4 completions with a full forward through the PLAIN
    # attention (reference einsum) on the card: bf16, over the prompt
    # and completion; int8, with the engine's quantized weights through
    # a fresh int8 paged cache, so the keys and values are quantized
    # as the engine's were.
    ref_model = rescore_model(cfg, eng, int8)
    checked = total = 0
    max_lp_gap = 0.0
    with torch.no_grad():
        for rid, ids, _ in reqs[:4]:
            r = done[rid]
            seq = np.concatenate([ids, r.tokens]).astype(np.int64)
            ids_t = torch.from_numpy(seq)[None].cuda()
            pos = torch.arange(len(seq), device="cuda")[None]
            cache = (init_paged_cache(
                L, 1, len(seq), cfg.num_kv_heads, cfg.head_dim,
                eng.cfg.page_size, device="cuda", quantized=True)
                if int8 else None)
            logits = ref_model(ids_t, pos, cache)[0]
            P, n = len(ids), len(r.tokens)
            lg = logits[P - 1:P - 1 + n]            # predicts tokens[0..n)
            top2 = torch.topk(lg, 2, dim=-1)
            margin = (top2.values[:, 0] - top2.values[:, 1]).cpu().numpy()
            argmax = top2.indices[:, 0].cpu().numpy()
            lp = torch.log_softmax(lg, dim=-1)
            lp_tok = lp.gather(1, torch.from_numpy(r.tokens).long().cuda()[
                :, None])[:, 0].cpu().numpy()
            max_lp_gap = max(max_lp_gap,
                             float(np.abs(lp_tok - r.policy_logprobs).max()))
            sure = margin > MARGIN
            total += n
            checked += int(sure.sum())
            bad = np.nonzero(sure & (argmax != r.tokens))[0]
            check(len(bad) == 0,
                  f"{phase}: req {rid} greedy token differs from the plain "
                  f"forward's argmax at positions {bad.tolist()} "
                  f"(margins {margin[bad].tolist()})")
    ttft = sorted(eng.ttft.values())
    return {"phase": phase, "card": card, "model": "pythia_1b",
            "dtype": "bfloat16",
            "int8": {"weights": eng.cfg.quantize_weights,
                     "kv": eng.cfg.quantize_kv},
            "requests": len(done),
            "generated_tokens": n_tokens, "waves": waves,
            "wall_s": wall, "tokens_per_s": n_tokens / wall,
            "ttft_p50_s": ttft[len(ttft) // 2],
            "preemptions": eng.preemptions, "launches": launches,
            "prefill_waves": prefills, "decode_steps": decodes,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "rescore": {"positions": total, "checked": checked,
                        "margin": MARGIN,
                        "max_policy_logprob_gap": max_lp_gap}}


# -- phases 6 and 7: GRPO training at Pythia-1B width ---------------------

def grad_agreement(trainer, mb, ref_model) -> dict:
    """Cosine and norm ratio between the policy's gradients (kernels A,
    B and C) and ``ref_model``'s (the plain attention, same weights) on
    one minibatch, over all parameters and over q/k/v_proj alone."""
    import torch

    grads = []
    for model in (trainer.model, ref_model):
        loss, _ = trainer.loss_fn(model, mb)
        params = dict(model.named_parameters())
        grads.append(dict(zip(params, torch.autograd.grad(
            loss, list(params.values())))))
    out = {}
    for scope, keep in (("all", lambda n: True),
                        ("qkv", lambda n: any(x in n for x in (
                            "q_proj", "k_proj", "v_proj")))):
        dot = n1 = n2 = 0.0
        for name, g1 in grads[0].items():
            if not keep(name):
                continue
            g1, g2 = g1.float(), grads[1][name].float()
            dot += (g1 * g2).sum().item()
            n1 += (g1 * g1).sum().item()
            n2 += (g2 * g2).sum().item()
        out[scope] = {"cosine": dot / (n1 * n2) ** 0.5,
                      "norm_ratio": (n1 / n2) ** 0.5}
    return out


def train_phase(card: str) -> dict:
    import dataclasses

    import torch

    from orion_tpu_torch.device import torch_dtype
    from orion_tpu_torch.models import Transformer
    from orion_tpu_torch.smoke import smoke_trainer_and_prompts

    cfg, tr, prompts = smoke_trainer_and_prompts(seed=0)
    mc = cfg.model
    check(cfg.rollout.group_prefix_sharing and tr.engine.supports_groups,
          "train: the rollout does not share group prefixes")

    # 1. Before any step: gradients on one minibatch through kernels A,
    # B and C against the plain attention with the same weights.
    experience, _ = tr.make_experience(next(prompts))
    mb = {k: v[:cfg.minibatch_size] for k, v in experience.items()}
    ref_model = Transformer(dataclasses.replace(
        mc, attention_impl="reference"), device="cuda",
        dtype=torch_dtype(mc.param_dtype))
    ref_model.load_state_dict(tr.model.state_dict())
    agree = grad_agreement(tr, mb, ref_model)
    del ref_model, experience, mb
    torch.cuda.empty_cache()
    for scope in ("all", "qkv"):
        check(agree[scope]["cosine"] >= GRAD_COS_MIN
              and abs(agree[scope]["norm_ratio"] - 1) <= GRAD_NORM_RTOL,
              f"train: {scope} gradients through the kernels disagree with "
              f"the plain attention's: {agree}")

    watch = ("layers.0.attn.q_proj.weight", "layers.15.attn.v_proj.weight",
             "embed.weight", "lm_head.weight")
    params = dict(tr.model.named_parameters())
    before = {n: params[n].detach().clone() for n in watch}
    # 2. Two counted iterations: finite results, the ratio at 1 on each
    # first minibatch, exact launch counts (run_counted); the
    # parameters moved.
    run = run_counted(tr, prompts, 2, "train")
    for n in watch:
        check(not torch.equal(before[n], params[n].detach()),
              f"train: {n} did not change")
    # 3. Weight sync: the engine's copy is the policy cast to bf16.
    eng = dict(tr.engine.model.named_parameters())
    for n, p in params.items():
        check(torch.equal(eng[n], p.detach().to(eng[n].dtype)),
              f"train: engine weight {n} differs from the policy's")

    return {"phase": "train", "card": card, "model": "pythia_1b",
            "param_dtype": mc.param_dtype, "dtype": mc.dtype,
            "grad_agreement": agree, "grad_cos_min": GRAD_COS_MIN,
            "grad_norm_rtol": GRAD_NORM_RTOL, **train_summary(cfg, run)}


def run_counted(tr, prompts, iterations: int, phase: str) -> dict:
    """Run ``iterations`` GRPO iterations with every kernel count set to
    0 just before and read just after, and check what every phase
    checks: finite losses and gradient norms, the importance ratio at 1
    on each iteration's first minibatch, and the launches of every
    kernel exactly as the waves, steps and minibatches imply."""
    import numpy as np
    import torch

    from orion_tpu_torch.ops.flash_attention import (flash_attention_gqa,
                                                     flash_bwd_dkv,
                                                     flash_bwd_dq)
    from orion_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_attention_int8)

    cfg = tr.cfg
    # Each iteration's first minibatch: its stats, and the gap between
    # its old logprobs (recomputed at batch 32) and the same rows
    # recomputed at batch 8, both as device tensors read after the run.
    n_mb = (cfg.rollout_batch_size * cfg.group_size // cfg.minibatch_size
            * cfg.num_epochs)
    update_fn, firsts = tr._update_fn, []

    def recording_update(experience, idx):
        first = tr.step % n_mb == 0
        if first:   # a diagnostic forward: its launches are not counted
            n_fwd = flash_attention_gqa.launches
            mb = {k: v[idx] for k, v in experience.items()}
            lp8 = tr.behavior_logprobs(mb["sequences"], mb["prompt_lens"],
                                       mb["mask"].shape[1]) * mb["mask"]
            gap = (lp8 - mb["old_logprobs"]).abs()
            flash_attention_gqa.launches = n_fwd
        stats = update_fn(experience, idx)
        if first:
            firsts.append((stats, gap.max(), gap.sum() / mb["mask"].sum()))
        return stats

    tr._update_fn = recording_update
    eng = tr.engine
    prefill0, decode0 = eng.prefill_forwards, eng.decode_steps
    kernels = {"flash_fwd": flash_attention_gqa,
               "paged_decode": paged_decode_attention,
               "paged_decode_int8": paged_decode_attention_int8,
               "flash_bwd_dq": flash_bwd_dq, "flash_bwd_dkv": flash_bwd_dkv}
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = tr.train(prompts, num_iterations=iterations)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    prefills = eng.prefill_forwards - prefill0
    decodes = eng.decode_steps - decode0
    del tr._update_fn
    first_mb = [{"iteration": i, "ratio_mean": float(st["ratio_mean"]),
                 "clip_frac": float(st["clip_frac"]),
                 "approx_kl": float(st["approx_kl"]),
                 "old_logprob_gap_max": float(gmax),
                 "old_logprob_gap_mean": float(gmean)}
                for i, (st, gmax, gmean) in enumerate(firsts)]

    for h in hist:
        check(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]),
              f"{phase}: non-finite loss or grad norm: {h}")
    # The importance ratio starts at 1: each iteration's first
    # minibatch, before that iteration's first step.
    check(len(first_mb) == len(hist),
          f"{phase}: first minibatches {first_mb}")
    for h in first_mb:
        check(abs(h["ratio_mean"] - 1) <= RATIO_TOL
              and h["clip_frac"] <= CLIP_FRAC_MAX,
              f"{phase}: first minibatch of iteration {h['iteration']}: {h}")
    # Launches, per layer: A once for each engine prefill wave (every
    # prompt has 64+ tokens; a group of 4 clones is one prefill row),
    # for the old and the ref logprobs and for each minibatch's
    # forward; D (bf16 pools) or D' (int8 pools) once for each decode
    # step, the other never; B and C once for each minibatch's
    # backward.
    L = cfg.model.num_layers
    iters_n = len(hist)
    decode = ("paged_decode_int8" if cfg.rollout.quantize_kv
              else "paged_decode")
    expect = {"flash_fwd": L * (prefills + (2 + n_mb) * iters_n),
              "paged_decode": 0, "paged_decode_int8": 0,
              "flash_bwd_dq": L * n_mb * iters_n,
              "flash_bwd_dkv": L * n_mb * iters_n}
    expect[decode] = L * decodes
    check(launches == expect and prefills > 0 and decodes > 0,
          f"{phase}: launches {launches}, expected {expect} ({prefills} "
          f"prefill waves, {decodes} decode steps)")
    return {"hist": hist, "wall_s": wall, "launches": launches,
            "prefill_waves": prefills, "decode_steps": decodes,
            "n_mb": n_mb, "first_minibatch": first_mb,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def train_summary(cfg, run) -> dict:
    hist, wall = run["hist"], run["wall_s"]
    iters = [{k: h[k] for k in (
        "iteration", "loss", "policy_loss", "kl", "entropy", "grad_norm",
        "ratio_mean", "clip_frac", "approx_kl", "reward_mean",
        "completion_len_mean", "time_rollout_s", "time_update_s",
        "samples_per_sec")} for h in hist]
    n_samples = cfg.rollout_batch_size * cfg.group_size
    tokens = sum(h["completion_len_mean"] * n_samples for h in hist)
    return {"rollouts_per_iteration": n_samples,
            "minibatches_per_iteration": run["n_mb"],
            "group_prefix_sharing": cfg.rollout.group_prefix_sharing,
            "ratio_tol": RATIO_TOL, "clip_frac_max": CLIP_FRAC_MAX,
            "first_minibatch": run["first_minibatch"], "iterations": iters,
            "wall_s": wall,
            "iteration_wall_s": [h["time_rollout_s"] + h["time_update_s"]
                                 for h in hist],
            "samples_per_s": n_samples * len(hist) / wall,
            "generated_tokens_per_s": tokens / wall,
            "launches": run["launches"],
            "prefill_waves": run["prefill_waves"],
            "decode_steps": run["decode_steps"],
            "peak_mem_gb": run["peak_mem_gb"]}


def train_int8_phase(card: str) -> dict:
    """One GRPO iteration whose rollout serves int8 weights and int8 KV
    pools; after the sync the engine's weights are the policy's
    prepared (cast to bf16, then quantized), bitwise."""
    import torch

    from orion_tpu_torch.models.transformer import (QuantLinear,
                                                    prep_decode_params)
    from orion_tpu_torch.smoke import smoke_trainer_and_prompts

    cfg, tr, prompts = smoke_trainer_and_prompts(seed=0, int8=True)
    check(all(isinstance(p, torch.nn.Parameter) and p.dtype == torch.float32
              for p in tr.model.parameters()),
          "train_int8: the policy must stay f32")
    run = run_counted(tr, prompts, 1, "train_int8")
    want = prep_decode_params(tr.model.state_dict(), cfg.model,
                              quantize_weights=True)
    have = tr.engine.model.state_dict()
    check(have.keys() == want.keys(),
          f"train_int8: engine keys {sorted(set(have) ^ set(want))}")
    n_q = 0
    for name, t in want.items():
        check(have[name].dtype == t.dtype and torch.equal(have[name], t),
              f"train_int8: engine weight {name} differs from the "
              "policy's prepared weight")
        n_q += name.endswith("weight_q")
    n_dense = sum(isinstance(m, QuantLinear)
                  for m in tr.engine.model.modules())
    check(n_q == n_dense > 0, f"train_int8: {n_q} int8 weights synced, "
          f"{n_dense} int8 Dense layers")
    return {"phase": "train_int8", "card": card, "model": "pythia_1b",
            "param_dtype": cfg.model.param_dtype, "dtype": cfg.model.dtype,
            "int8": {"weights": cfg.rollout.quantize_weights,
                     "kv": cfg.rollout.quantize_kv},
            "int8_weights_synced": n_q, **train_summary(cfg, run)}


# -- phase 8: a sequence-parallel training step at 8,192 tokens ----------

LONGCTX_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                   "flash_chunk_fwd", "flash_chunk_bwd_dq",
                   "flash_chunk_bwd_dkv")


def _longctx_step(model, ids, tgt, ring):
    """One loss and backward of the long-context mix (``ring`` None:
    dense), every kernel count set to 0 just before and read just
    after.  Returns (loss, gradients, wall seconds, launches, peak GB)."""
    import torch

    from orion_tpu_torch.ops import flash_attention as fa
    from orion_tpu_torch.smoke import longctx_loss

    kernels = {"flash_fwd": fa.flash_attention_gqa,
               **{name: getattr(fa, name) for name in LONGCTX_KERNELS[1:]}}
    params = list(model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    loss = longctx_loss(model, ids, tgt, ring)
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    return (loss.item(), grads, wall, launches,
            torch.cuda.max_memory_allocated() / 1e9)


def longctx_phase(card: str) -> dict:
    import torch

    from orion_tpu_torch.config import OptimizerConfig
    from orion_tpu_torch.smoke import smoke_longctx
    from orion_tpu_torch.trainers.base import (clip_by_global_norm,
                                               make_optimizer)

    cfg, model, dense, ids, tgt, ring = smoke_longctx(seed=0)
    L, S, n = ids.shape[1], ring.size, cfg.num_layers

    # 1. The counted steps: the ring, then dense on the same weights.
    ring_loss, ring_grads, ring_wall, ring_launches, ring_peak = \
        _longctx_step(model, ids, tgt, ring)
    dense_loss, dense_grads, dense_wall, dense_launches, dense_peak = \
        _longctx_step(dense, ids, tgt, None)
    zero = dict.fromkeys(LONGCTX_KERNELS, 0)
    expect_ring = {**zero, "flash_chunk_fwd": n * S,
                   "flash_chunk_bwd_dq": n * S, "flash_chunk_bwd_dkv": n * S}
    expect_dense = {**zero, "flash_fwd": n, "flash_bwd_dq": n,
                    "flash_bwd_dkv": n}
    check(ring_launches == expect_ring,
          f"longctx: ring step launches {ring_launches}, expected "
          f"{expect_ring}")
    check(dense_launches == expect_dense,
          f"longctx: dense step launches {dense_launches}, expected "
          f"{expect_dense}")

    # 2. Every parameter's gradient, ring against dense.  The k_proj
    # bias is held on each head's rotary dims only: on the others its
    # exact gradient is 0 (the bias shifts every score of a row by the
    # same q·b, which the softmax cancels), so both steps hold only
    # rounding noise there, whose share of the norm is reported.
    rot = int(cfg.head_dim * cfg.rotary_pct)
    live = (torch.arange(cfg.num_kv_heads * cfg.head_dim, device="cuda")
            % cfg.head_dim) < rot
    per_param = {}
    dot = n1 = n2 = 0.0
    for (name, _), g1, g2 in zip(model.named_parameters(), ring_grads,
                                 dense_grads):
        g1, g2 = g1.float(), g2.float()
        a, b = (g1 * g1).sum().item(), (g2 * g2).sum().item()
        dot, n1, n2 = dot + (g1 * g2).sum().item(), n1 + a, n2 + b
        row = {}
        if name.endswith("attn.k_proj.bias") and rot < cfg.head_dim:
            row["zero_part_norm_share"] = {
                "ring": (g1[~live].square().sum().item() / a) ** 0.5,
                "dense": (g2[~live].square().sum().item() / b) ** 0.5}
            g1, g2 = g1[live], g2[live]
            a, b = (g1 * g1).sum().item(), (g2 * g2).sum().item()
        d = (g1 * g2).sum().item()
        per_param[name] = {"cosine": d / max((a * b) ** 0.5, 1e-30),
                           "norm_ratio": (a / max(b, 1e-30)) ** 0.5, **row}
    del dense_grads
    failing = {name: r for name, r in per_param.items()
               if r["cosine"] < GRAD_COS_MIN
               or abs(r["norm_ratio"] - 1) > GRAD_NORM_RTOL}
    worst = min(per_param, key=lambda k: per_param[k]["cosine"])
    agree = {"all": {"cosine": dot / (n1 * n2) ** 0.5,
                     "norm_ratio": (n1 / n2) ** 0.5},
             "worst_param": worst, "worst": per_param[worst],
             "failing": failing}

    # 3. The walls again, warm, in turns: the counted pair paid the
    # first use of each GEMM shape and kernel.
    warm = {"ring": _longctx_step(model, ids, tgt, ring)[2],
            "dense": _longctx_step(dense, ids, tgt, None)[2]}
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "longctx_gradients", "card": card,
          "loss_ring": ring_loss, "loss_dense": dense_loss,
          "wall_s": {"ring": ring_wall, "dense": dense_wall},
          "warm_wall_s": warm, "per_param": per_param})
    check(abs(ring_loss - dense_loss) <= LONGCTX_LOSS_ATOL,
          f"longctx: ring loss {ring_loss} vs dense loss {dense_loss}")
    check(not failing, "longctx: gradients of the ring step disagree with "
          f"the dense step's: {failing}")

    # 4. One AdamW step from the ring's gradients, with the smoke
    # trainer's optimizer settings (global-norm clip, then AdamW).
    ocfg = OptimizerConfig(learning_rate=1e-6, grad_clip=1.0)
    params = list(model.parameters())
    grad_norm = clip_by_global_norm(list(ring_grads), ocfg.grad_clip).item()
    for p, g in zip(params, ring_grads):
        p.grad = g
    del ring_grads
    watch = ("layers.0.attn.q_proj.weight", "layers.15.attn.k_proj.weight",
             "embed.weight")
    named = dict(model.named_parameters())
    before = {name: named[name].detach().clone() for name in watch}
    make_optimizer(ocfg, params).step()
    check(all(bool(torch.isfinite(p).all()) for p in params),
          "longctx: a parameter is not finite after the AdamW step")
    for name in watch:
        check(not torch.equal(before[name], named[name].detach()),
              f"longctx: {name} did not change in the AdamW step")
    return {"phase": "longctx", "card": card, "model": "pythia_1b",
            "layers": n, "param_dtype": cfg.param_dtype, "dtype": cfg.dtype,
            "seq_len": L, "ring": S, "layout": "zigzag",
            "tokens_per_shard": L // S, "loss_ring": ring_loss,
            "loss_dense": dense_loss,
            "loss_gap": abs(ring_loss - dense_loss),
            "loss_atol": LONGCTX_LOSS_ATOL, "grad_agreement": agree,
            "grad_cos_min": GRAD_COS_MIN, "grad_norm_rtol": GRAD_NORM_RTOL,
            "grad_norm_before_clip": grad_norm,
            "wall_s": {"ring": ring_wall, "dense": dense_wall},
            "warm_wall_s": warm,
            "peak_mem_gb": {"ring": ring_peak, "dense": dense_peak},
            "launches_ring": ring_launches, "launches_dense": dense_launches,
            # Each kernel ran on one of the two steps only.
            "launches": {k: ring_launches[k] + dense_launches[k]
                         for k in LONGCTX_KERNELS}}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "orion_tpu_torch")):
        print("chip_smoke: orion_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from orion_tpu_torch.ops import cuda_build
    from orion_tpu_torch.runtime import scheduler

    card = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": card, "name": kind,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    sched_box = {}
    th = threading.Thread(target=lambda: sched_box.setdefault(
        "native", scheduler.native_available()))
    th.start()
    kernel_s = cuda_build.build()
    th.join()
    ptxas = {}
    for name in cuda_build.KERNELS:
        path = cuda_build._library_path(name) + ".ptxas.txt"
        if os.path.exists(path):
            with open(path) as f:
                # Each instance's mangled name, then its spill and
                # register lines.
                ptxas[name] = [
                    ln.split("'")[1] if "entry function" in ln
                    else ln.strip() for ln in f
                    if "entry function" in ln or "registers" in ln
                    or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernel_seconds": kernel_s,
          "scheduler": "native" if sched_box["native"] else "python",
          "ptxas": ptxas})
    # The tensor-core bodies (A, A', B, B') keep every accumulator in
    # registers: an instance that spills fails the build phase.
    for name, lines in ptxas.items():
        for entry, spill in zip(lines, lines[1:]):
            if "wgmma_kernel" in entry:
                check(spill.startswith("0 bytes stack frame, 0 bytes spill"),
                      f"build: {name} instance {entry} spills: {spill}")

    flash = [flash_case("pythia_prefill", 8, 512, 640, 8, 8, 256, 1),
             flash_case("llama_gqa", 4, 256, 320, 32, 8, 64, 2),
             flash_case("verify", 8, 5, 388, 8, 8, 256, 3)]
    paged = [paged_case("pythia_decode", 32, 8, 8, 256, 64, 10, 4),
             paged_case("llama_gqa", 32, 32, 8, 64, 64, 10, 5)]
    paged_int8 = [
        paged_int8_case("pythia_decode", 32, 8, 8, 256, 64, 10, 9),
        paged_int8_case("llama_gqa", 32, 32, 8, 64, 64, 10, 10)]
    bwd = [flash_bwd_case("pythia_train", 8, 384, 384, 8, 8, 256, None, 6),
           flash_bwd_case("llama_gqa", 4, 256, 256, 32, 8, 64, None, 7),
           flash_bwd_case("odd_ragged", 4, 389, 397, 8, 8, 256, 8, 8)]
    chunk = [chunk_case("pythia_ring", 4, 1, 8192, 8, 8, 256, 11),
             chunk_case("llama_gqa_ring", 4, 1, 4096, 32, 8, 64, 12)]
    emit({"phase": "kernels", "names": list(cuda_build.KERNELS),
          "card": card, "err_factor": ERR_FACTOR, "lse_tol": LSE_TOL,
          "flash_fwd": flash, "paged_decode": paged,
          "paged_decode_int8": paged_int8, "flash_bwd": bwd,
          "flash_chunk": chunk})
    gc.collect()
    torch.cuda.empty_cache()

    runs = {}
    for name, phase in (("engine", lambda: engine_phase(card)),
                        ("engine_int8", lambda: engine_phase(card, True)),
                        ("train", lambda: train_phase(card)),
                        ("train_int8", lambda: train_int8_phase(card)),
                        ("longctx", lambda: longctx_phase(card))):
        runs[name] = phase()
        emit(runs[name])
        gc.collect()
        torch.cuda.empty_cache()

    # Launches of each kernel on each path that runs it (0 where the
    # path must not: D on the int8 paths, D' on the bf16 ones).  The
    # longctx path counts its ring step (A', B', C') and its dense step
    # (A, B, C) together.
    by_path = {}
    for path, res in runs.items():
        for kname, n in res["launches"].items():
            if n or kname.startswith("paged_decode"):
                by_path.setdefault(kname, {})[path] = n

    def row(name, source, replaces, case):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(by_path[name].values()),
                "launches_by_path": by_path[name],
                "max_abs_err": case["max_abs_err"], "ms": case["ms"],
                "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
                "bound_by": case["bound_by"],
                "library_ms": case["library_ms"]}

    emit({"kernels": [
        row("flash_fwd", "orion_tpu_torch/csrc/flash_fwd.cu",
            "orion_tpu/ops/pallas/flash_attention.py:162", flash[0]),
        row("paged_decode", "orion_tpu_torch/csrc/paged_decode.cu",
            "orion_tpu/ops/pallas/paged_attention.py:134", paged[0]),
        row("paged_decode_int8", "orion_tpu_torch/csrc/paged_decode.cu",
            "orion_tpu/ops/pallas/paged_attention.py:213", paged_int8[0]),
        row("flash_bwd_dq", "orion_tpu_torch/csrc/flash_bwd_dq.cu",
            "orion_tpu/ops/pallas/flash_attention.py:339",
            bwd[0]["flash_bwd_dq"]),
        row("flash_bwd_dkv", "orion_tpu_torch/csrc/flash_bwd_dkv.cu",
            "orion_tpu/ops/pallas/flash_attention.py:397",
            bwd[0]["flash_bwd_dkv"]),
        row("flash_chunk_fwd", "orion_tpu_torch/csrc/flash_fwd.cu",
            "orion_tpu/ops/pallas/flash_attention.py:575",
            chunk[0]["flash_chunk_fwd"]),
        row("flash_chunk_bwd_dq", "orion_tpu_torch/csrc/flash_bwd_dq.cu",
            "orion_tpu/ops/pallas/flash_attention.py:590",
            chunk[0]["flash_chunk_bwd_dq"]),
        row("flash_chunk_bwd_dkv", "orion_tpu_torch/csrc/flash_bwd_dkv.cu",
            "orion_tpu/ops/pallas/flash_attention.py:590",
            chunk[0]["flash_chunk_bwd_dkv"])]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
