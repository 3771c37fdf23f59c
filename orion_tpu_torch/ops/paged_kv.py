"""Paged KV cache: page pools + block tables (port of
``orion_tpu/ops/paged_kv.py``).

Each layer owns pools ``k_pages``/``v_pages`` [num_pages, Hkv, ps, D];
a block table maps (sequence, page slot) -> pool page.  int8 pools
carry f32 scale pools ``k_scales``/``v_scales`` [num_pages, Hkv, 1, ps]
(one scale per (token, head); ops/quant.py).  Unlike the JAX version,
which returns updated pools, ``write_paged_tokens`` updates the pools
IN PLACE: the pools are the largest tensors of a serving run and a
functional copy per write would double them.
"""

from __future__ import annotations

from typing import List

import torch

from orion_tpu_torch.ops.quant import dequant_kv, quantize_kv


def init_pools(num_pages: int, num_kv_heads: int, head_dim: int,
               page_size: int, dtype=torch.bfloat16, device=None,
               quantized: bool = False) -> dict:
    """One layer's ZERO-initialised pools {"k_pages", "v_pages"}
    [num_pages, Hkv, ps, D] in ``dtype`` — or int8 plus f32 scale pools
    {"k_scales", "v_scales"} [num_pages, Hkv, 1, ps] with ``quantized``.
    Zeros matter: masked slots still enter the PV product with p = 0,
    and 0 * NaN from uninitialised memory would be NaN."""
    shape = (num_pages, num_kv_heads, page_size, head_dim)
    sshape = (num_pages, num_kv_heads, 1, page_size)
    pool_dtype = torch.int8 if quantized else dtype
    out = {"k_pages": torch.zeros(shape, dtype=pool_dtype, device=device),
           "v_pages": torch.zeros(shape, dtype=pool_dtype, device=device)}
    if quantized:
        out["k_scales"] = torch.zeros(sshape, dtype=torch.float32,
                                      device=device)
        out["v_scales"] = torch.zeros(sshape, dtype=torch.float32,
                                      device=device)
    return out


def init_paged_cache(num_layers: int, batch: int, max_len: int,
                     num_kv_heads: int, head_dim: int, page_size: int,
                     num_pages: int = 0, dtype=torch.bfloat16,
                     device=None, quantized: bool = False) -> List[dict]:
    """Per-layer {"k_pages", "v_pages", "block_tables"} (plus the scale
    pools with ``quantized``; see :func:`init_pools`) with a contiguous
    block-table assignment (seq b gets pages [b*m, (b+1)*m))."""
    pages_per_seq = -(-max_len // page_size)
    if num_pages <= 0:
        num_pages = batch * pages_per_seq
    if num_pages < batch * pages_per_seq:
        raise ValueError(
            f"pool of {num_pages} pages < {batch}x{pages_per_seq} needed")
    bt = (torch.arange(batch, dtype=torch.int32, device=device)[:, None]
          * pages_per_seq
          + torch.arange(pages_per_seq, dtype=torch.int32,
                         device=device)[None, :])
    return [{**init_pools(num_pages, num_kv_heads, head_dim, page_size,
                          dtype, device, quantized), "block_tables": bt}
            for _ in range(num_layers)]


def write_paged_tokens(layer_cache: dict, k_new: torch.Tensor,
                       v_new: torch.Tensor,
                       positions: torch.Tensor) -> dict:
    """Scatter new tokens into the pools, in place.

    k_new/v_new [B, L, Hkv, D]; positions [B, L] absolute positions.
    Token (b, t) lands in page block_tables[b, pos // ps] at slot
    pos % ps.  Every position must lie inside the block table (the
    engine guarantees it); returns ``layer_cache``.  int8 pools take
    the tokens quantized per (token, head) over D, values and scales
    (``scales[pages, :, 0, slots]``) scattered alike."""
    bt = layer_cache["block_tables"]
    ps = layer_cache["k_pages"].shape[2]
    pos = positions.to(torch.int64)
    pages = torch.gather(bt.to(torch.int64), 1, pos // ps)     # [B, L]
    slots = pos % ps
    if "k_scales" in layer_cache:
        kq, ks = quantize_kv(k_new)          # [B, L, Hkv, D], [B, L, Hkv]
        vq, vs = quantize_kv(v_new)
        layer_cache["k_pages"][pages, :, slots, :] = kq
        layer_cache["v_pages"][pages, :, slots, :] = vq
        layer_cache["k_scales"][pages, :, 0, slots] = ks
        layer_cache["v_scales"][pages, :, 0, slots] = vs
        return layer_cache
    # pools[pages, :, slots, :] selects [B, L, Hkv, D], like k_new.
    layer_cache["k_pages"][pages, :, slots, :] = k_new.to(
        layer_cache["k_pages"].dtype)
    layer_cache["v_pages"][pages, :, slots, :] = v_new.to(
        layer_cache["v_pages"].dtype)
    return layer_cache


def gather_paged_kv(layer_cache: dict, dtype=torch.bfloat16) -> tuple:
    """Gather each sequence's pages into slot order: (k, v)
    [B, max_pages*ps, Hkv, D] where slot j holds position j.  Used by
    the prefill path; callers mask by position.  Float pools come back
    in their own dtype; int8 pools dequantized into ``dtype``."""
    bt = layer_cache["block_tables"].to(torch.int64)
    B, max_pages = bt.shape
    _, Hkv, ps, D = layer_cache["k_pages"].shape

    def gather(pages):
        g = pages[bt]                                # [B, mp, Hkv, ps, D]
        return g.transpose(2, 3).reshape(B, max_pages * ps, Hkv, D)

    k, v = gather(layer_cache["k_pages"]), gather(layer_cache["v_pages"])
    if "k_scales" in layer_cache:
        def gather_s(scales):                        # [N, Hkv, 1, ps]
            g = scales[:, :, 0, :][bt]               # [B, mp, Hkv, ps]
            return g.transpose(2, 3).reshape(B, max_pages * ps, Hkv)

        k = dequant_kv(k, gather_s(layer_cache["k_scales"]), dtype)
        v = dequant_kv(v, gather_s(layer_cache["v_scales"]), dtype)
    return k, v


def is_paged(layer_cache) -> bool:
    return layer_cache is not None and "k_pages" in layer_cache
