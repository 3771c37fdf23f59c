#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``orion_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels), ``nvcc`` and
``g++``; builds everything it runs from the checkout.  Phases, each
printing one JSON line:

1. ``device``  — the card's name and power limit (``nvidia-smi``).
2. ``build``   — the CUDA kernels (one ``nvcc`` per source, all started
   together) and the native page scheduler, with their build seconds.
3. ``kernels`` — each kernel against its plain PyTorch version on the
   card in bf16 at the serving and training slices' shapes, with times
   and bounds.
4. ``engine``  — the continuous-batching engine at Pythia-1B width
   (random seeded weights, bf16) serves 64 greedy requests; both kernel
   launch counts must rise; 4 completions are re-scored by a full
   forward with the plain attention.
5. ``train``   — the GRPO trainer at Pythia-1B width and full depth
   (f32 master weights from a seed, bf16 compute) runs 2 iterations of
   32 rollouts; gradients through kernels A, B and C agree with the
   plain attention's before the first step, every loss and gradient
   norm is finite, the importance ratio starts at 1, the kernel launch
   counts rise as the code implies, and the engine's weights equal the
   policy's cast to bf16 after the weight sync.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line,
and as the last line ``{"ok": true, "device": {...}}``.  Any failed
check exits non-zero before that line.  Without a CUDA device, or
without the ``orion_tpu_torch`` package beside this file, it exits 1
and prints no result.
"""

from __future__ import annotations

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
# engine-vs-plain policy logprob gap, printed beside it).
MARGIN = 0.25


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
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


# -- phase 4: the engine at Pythia-1B width -------------------------------

def engine_phase(card: str) -> dict:
    import dataclasses

    import numpy as np
    import torch

    from orion_tpu_torch.models import Transformer
    from orion_tpu_torch.ops.flash_attention import flash_attention_gqa
    from orion_tpu_torch.ops.paged_attention import paged_decode_attention
    from orion_tpu_torch.smoke import EOS, smoke_engine_and_requests

    # Warmed up inside, outside the counted run.
    cfg, model, eng, reqs = smoke_engine_and_requests(64, seed=0)

    prefill0, decode0 = eng.prefill_forwards, eng.decode_steps
    flash_attention_gqa.launches = 0
    paged_decode_attention.launches = 0
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
        check(waves < 10000, "engine: no progress")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention_gqa.launches,
                "paged_decode": paged_decode_attention.launches}

    check(sorted(done) == list(range(64)), "engine: missing completions")
    n_tokens = 0
    for rid, ids, budget in reqs:
        r = done[rid]
        n = len(r.tokens)
        n_tokens += n
        check(1 <= n <= budget, f"engine: req {rid} length {n} > {budget}")
        check(n == budget or r.tokens[-1] == EOS,
              f"engine: req {rid} stopped early without EOS")
        check(bool(np.isfinite(r.logprobs).all()),
              f"engine: req {rid} non-finite logprobs")
    # Per layer, A once for each prefill wave (every prompt has 64+
    # tokens) and D once for each decode step.
    L = cfg.num_layers
    prefills = eng.prefill_forwards - prefill0
    decodes = eng.decode_steps - decode0
    expect = {"flash_fwd": L * prefills, "paged_decode": L * decodes}
    check(launches == expect and prefills > 0 and decodes > 0,
          f"engine: launches {launches}, expected {expect} ({prefills} "
          f"prefill waves, {decodes} decode steps)")

    # Re-score 4 completions with a full forward through the PLAIN
    # attention (reference einsum) on the card.
    ref_model = Transformer(dataclasses.replace(
        cfg, attention_impl="reference"), device="cuda")
    ref_model.load_state_dict(model.state_dict())
    checked = total = 0
    max_lp_gap = 0.0
    with torch.no_grad():
        for rid, ids, _ in reqs[:4]:
            r = done[rid]
            seq = np.concatenate([ids, r.tokens]).astype(np.int64)
            ids_t = torch.from_numpy(seq)[None].cuda()
            pos = torch.arange(len(seq), device="cuda")[None]
            logits = ref_model(ids_t, pos)[0]
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
                  f"engine: req {rid} greedy token differs from the plain "
                  f"forward's argmax at positions {bad.tolist()} "
                  f"(margins {margin[bad].tolist()})")
    ttft = sorted(eng.ttft.values())
    return {"phase": "engine", "card": card, "model": "pythia_1b",
            "dtype": "bfloat16", "requests": len(done),
            "generated_tokens": n_tokens, "waves": waves,
            "wall_s": wall, "tokens_per_s": n_tokens / wall,
            "ttft_p50_s": ttft[len(ttft) // 2],
            "preemptions": eng.preemptions, "launches": launches,
            "prefill_waves": prefills, "decode_steps": decodes,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "rescore": {"positions": total, "checked": checked,
                        "margin": MARGIN,
                        "max_policy_logprob_gap": max_lp_gap}}


# -- phase 5: GRPO training at Pythia-1B width ---------------------------

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

    import numpy as np
    import torch

    from orion_tpu_torch.device import torch_dtype
    from orion_tpu_torch.models import Transformer
    from orion_tpu_torch.ops.flash_attention import (flash_attention_gqa,
                                                     flash_bwd_dkv,
                                                     flash_bwd_dq)
    from orion_tpu_torch.ops.paged_attention import paged_decode_attention
    from orion_tpu_torch.smoke import smoke_trainer_and_prompts

    cfg, tr, prompts = smoke_trainer_and_prompts(seed=0)
    mc = cfg.model

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
    flash_attention_gqa.launches = 0
    paged_decode_attention.launches = 0
    flash_bwd_dq.launches = 0
    flash_bwd_dkv.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = tr.train(prompts, num_iterations=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention_gqa.launches,
                "paged_decode": paged_decode_attention.launches,
                "flash_bwd_dq": flash_bwd_dq.launches,
                "flash_bwd_dkv": flash_bwd_dkv.launches}
    prefills = eng.prefill_forwards - prefill0
    decodes = eng.decode_steps - decode0
    del tr._update_fn
    first_mb = [{"iteration": i, "ratio_mean": float(st["ratio_mean"]),
                 "clip_frac": float(st["clip_frac"]),
                 "approx_kl": float(st["approx_kl"]),
                 "old_logprob_gap_max": float(gmax),
                 "old_logprob_gap_mean": float(gmean)}
                for i, (st, gmax, gmean) in enumerate(firsts)]

    # 2. Finite results, and the parameters moved.
    for h in hist:
        check(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]),
              f"train: non-finite loss or grad norm: {h}")
    for n in watch:
        check(not torch.equal(before[n], params[n].detach()),
              f"train: {n} did not change")
    # 3. The importance ratio starts at 1: each iteration's first
    # minibatch, before that iteration's first step.
    check(len(first_mb) == len(hist), f"train: first minibatches {first_mb}")
    for h in first_mb:
        check(abs(h["ratio_mean"] - 1) <= RATIO_TOL
              and h["clip_frac"] <= CLIP_FRAC_MAX,
              f"train: first minibatch of iteration {h['iteration']}: {h}")
    # 4. Launches, per layer: A once for each engine prefill wave (every
    # prompt has 64+ tokens), for the old and the ref logprobs and for
    # each minibatch's forward; D once for each decode step; B and C
    # once for each minibatch's backward.
    L = mc.num_layers
    iters_n = len(hist)
    expect = {"flash_fwd": L * (prefills + (2 + n_mb) * iters_n),
              "paged_decode": L * decodes,
              "flash_bwd_dq": L * n_mb * iters_n,
              "flash_bwd_dkv": L * n_mb * iters_n}
    check(launches == expect,
          f"train: launches {launches}, expected {expect} ({prefills} "
          f"prefill waves, {decodes} decode steps)")
    # 5. Weight sync: the engine's copy is the policy cast to bf16.
    eng = dict(tr.engine.model.named_parameters())
    for n, p in params.items():
        check(torch.equal(eng[n], p.detach().to(eng[n].dtype)),
              f"train: engine weight {n} differs from the policy's")

    iters = [{k: h[k] for k in (
        "iteration", "loss", "policy_loss", "kl", "entropy", "grad_norm",
        "ratio_mean", "clip_frac", "approx_kl", "reward_mean",
        "completion_len_mean", "time_rollout_s", "time_update_s",
        "samples_per_sec")} for h in hist]
    n_samples = cfg.rollout_batch_size * cfg.group_size
    tokens = sum(h["completion_len_mean"] * n_samples for h in hist)
    return {"phase": "train", "card": card, "model": "pythia_1b",
            "param_dtype": mc.param_dtype, "dtype": mc.dtype,
            "rollouts_per_iteration": n_samples,
            "minibatches_per_iteration": n_mb, "grad_agreement": agree,
            "grad_cos_min": GRAD_COS_MIN, "grad_norm_rtol": GRAD_NORM_RTOL,
            "ratio_tol": RATIO_TOL, "clip_frac_max": CLIP_FRAC_MAX,
            "first_minibatch": first_mb, "iterations": iters, "wall_s": wall,
            "iteration_wall_s": [h["time_rollout_s"] + h["time_update_s"]
                                 for h in hist],
            "samples_per_s": n_samples * len(hist) / wall,
            "generated_tokens_per_s": tokens / wall,
            "launches": launches, "prefill_waves": prefills,
            "decode_steps": decodes,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


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
                ptxas[name] = [ln.strip() for ln in f
                               if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernel_seconds": kernel_s,
          "scheduler": "native" if sched_box["native"] else "python",
          "ptxas": ptxas})

    flash = [flash_case("pythia_prefill", 8, 512, 640, 8, 8, 256, 1),
             flash_case("llama_gqa", 4, 256, 320, 32, 8, 64, 2),
             flash_case("verify", 8, 5, 388, 8, 8, 256, 3)]
    paged = [paged_case("pythia_decode", 32, 8, 8, 256, 64, 10, 4),
             paged_case("llama_gqa", 32, 32, 8, 64, 64, 10, 5)]
    bwd = [flash_bwd_case("pythia_train", 8, 384, 384, 8, 8, 256, None, 6),
           flash_bwd_case("llama_gqa", 4, 256, 256, 32, 8, 64, None, 7),
           flash_bwd_case("odd_ragged", 4, 389, 397, 8, 8, 256, 8, 8)]
    emit({"phase": "kernels", "names": list(cuda_build.KERNELS),
          "card": card, "err_factor": ERR_FACTOR, "lse_tol": LSE_TOL,
          "flash_fwd": flash, "paged_decode": paged, "flash_bwd": bwd})

    eng = engine_phase(card)
    emit(eng)
    torch.cuda.empty_cache()
    train = train_phase(card)
    emit(train)

    by_path = {"flash_fwd": {"engine": eng["launches"]["flash_fwd"],
                             "train": train["launches"]["flash_fwd"]},
               "paged_decode": {"engine": eng["launches"]["paged_decode"],
                                "train": train["launches"]["paged_decode"]},
               "flash_bwd_dq": {"train": train["launches"]["flash_bwd_dq"]},
               "flash_bwd_dkv": {
                   "train": train["launches"]["flash_bwd_dkv"]}}

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
        row("flash_bwd_dq", "orion_tpu_torch/csrc/flash_bwd_dq.cu",
            "orion_tpu/ops/pallas/flash_attention.py:339",
            bwd[0]["flash_bwd_dq"]),
        row("flash_bwd_dkv", "orion_tpu_torch/csrc/flash_bwd_dkv.cu",
            "orion_tpu/ops/pallas/flash_attention.py:397",
            bwd[0]["flash_bwd_dkv"])]})
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
