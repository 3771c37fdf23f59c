"""Attention ops: the reference einsum and the implementation dispatch
(port of ``orion_tpu/ops/attention.py``)."""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -0.7 * torch.finfo(torch.float32).max


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, L, Hkv, D] -> [B, L, Hkv*n_rep, D] (GQA head expansion)."""
    if n_rep == 1:
        return x
    b, l, h, d = x.shape
    return x[:, :, :, None, :].expand(b, l, h, n_rep, d).reshape(
        b, l, h * n_rep, d)


def reference_attention_gqa(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """Masked multi-head attention with GQA grouping (no repeated KV).

    q [B, Lq, H, D], k/v [B, Lk, Hkv, D], mask [B, Lq, Lk] bool (True =
    attend).  Scores and softmax in f32; the probabilities are cast to
    q's dtype before the PV product, as the JAX reference does.
    Returns [B, Lq, H, D] in q.dtype."""
    B, Lq, H, D = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Lq, Hkv, g, D).to(torch.float32)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                          k.to(torch.float32)) * scale
    scores = scores.masked_fill(~mask[:, None, None, :, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(q.dtype), v)
    return out.reshape(B, Lq, H, D)


def causal_mask(q_positions: torch.Tensor, lk: int) -> torch.Tensor:
    """[B, Lq, Lk] bool: query at position p attends kv slot j iff j <= p."""
    slots = torch.arange(lk, dtype=q_positions.dtype,
                         device=q_positions.device)
    return slots[None, None, :] <= q_positions[:, :, None]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor], scale: float,
              impl: str = "auto",
              q_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch on the attention implementation.

    ``"auto"``: on CUDA with Lq > 1 and ``q_positions`` given, the hand
    flash kernel (positional rule ``kv_slot <= q_position``; ``mask``
    is not read); otherwise the reference einsum over ``mask``.
    ``"reference"``: always the reference.  ``mask`` None means the
    positional causal mask built from ``q_positions``.

    Sequence-parallel impls, for Lq > 1 inside
    ``orion_tpu_torch.parallel.sequence_parallel(ring)`` with the
    activations sharded on the sequence (they raise outside one, and
    without ``q_positions``; ``mask`` is not read): ``"ring"`` — k and
    v rotate around the ring through kernels A′/B′/C′, the keys at the
    queries' own positions; ``"ulysses"`` — the all-to-all head/sequence
    swap around kernel A.  Lq == 1 takes the reference, as in the JAX
    package.
    """
    if impl in ("ring", "ulysses") and q.shape[1] > 1:
        if q_positions is None:
            raise ValueError(f"{impl} attention requires q_positions")
        from orion_tpu_torch.parallel.longctx import (active_ring,
                                                      ring_attention,
                                                      ulysses_attention)
        ring = active_ring(impl)
        if impl == "ring":
            return ring_attention(q, k, v, q_positions, q_positions, scale,
                                  ring)
        return ulysses_attention(q, k, v, q_positions, scale, ring)
    if (impl == "auto" and q.is_cuda and q.shape[1] > 1
            and q_positions is not None):
        from orion_tpu_torch.ops.flash_attention import flash_attention_gqa
        return flash_attention_gqa(q, k, v, q_positions, scale)
    if mask is None:
        if q_positions is None:
            raise ValueError("attention needs a mask or q_positions")
        mask = causal_mask(q_positions, k.shape[1])
    return reference_attention_gqa(q, k, v, mask, scale)
