"""Paged-KV decode attention: the wrapper around kernels D and D'
(``csrc/paged_decode.cu``) and their plain PyTorch version.

Replaces ``orion_tpu/ops/pallas/paged_attention.py``
``paged_decode_attention`` / ``_decode_kernel``: D over bf16/f32 pools,
D' over int8 pools with f32 per-slot scale pools (``k_scales`` /
``v_scales``, reached through ``paged_decode_attention_int8`` as in the
reference).  On this card both are bounded by bytes (each valid K/V row
is read once per step for a few flops per byte); a block serves all
query heads of one kv head so every page is read once — see the
source's header for the design.

The wrapper runs the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises.  D's launches are counted in
``paged_decode_attention.launches``, D''s apart in
``paged_decode_attention_int8.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from orion_tpu_torch.ops import cuda_build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
_MAX_REP = 8


def paged_decode_attention_reference(q: torch.Tensor, k_pages: torch.Tensor,
                                     v_pages: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     seq_lens: torch.Tensor,
                                     scale: float, k_scales=None,
                                     v_scales=None) -> torch.Tensor:
    """Plain PyTorch version of kernels D and D' (gather + masked
    softmax in f32), mirroring ``paged_decode_attention_reference`` of
    the JAX package: head h reads kv head h // n_rep, slots idx >=
    seq_len are masked, the normaliser is clamped at 1e-30.  With int8
    pools the K scales multiply the scores before the mask and the V
    scales the probabilities after the normaliser is taken.  Returns
    [B, H, D] in q.dtype."""
    B, H, D = q.shape
    _, Hkv, ps, _ = k_pages.shape
    mp = block_tables.shape[1]
    n_rep = H // Hkv
    bt = block_tables.to(torch.int64)

    def gather(pages):                      # -> [B, Hkv, mp*ps, D] f32
        g = pages[bt]                       # [B, mp, Hkv, ps, D]
        return (g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, mp * ps, D)
                .to(torch.float32))

    def gather_s(scales):                   # [N, Hkv, 1, ps] -> [B, Hkv, S]
        g = scales[:, :, 0, :][bt]          # [B, mp, Hkv, ps]
        return g.permute(0, 2, 1, 3).reshape(B, Hkv, mp * ps)

    k = gather(k_pages)
    v = gather(v_pages)
    qh = q.reshape(B, Hkv, n_rep, D).to(torch.float32) * scale
    s = torch.einsum("bkrd,bksd->bkrs", qh, k)
    if k_scales is not None:
        s = s * gather_s(k_scales)[:, :, None, :]
    idx = torch.arange(mp * ps, device=q.device)
    valid = idx[None, None, None, :] < seq_lens.to(idx.dtype)[
        :, None, None, None]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    if v_scales is not None:
        p = p * gather_s(v_scales)[:, :, None, :]
    out = torch.einsum("bkrs,bksd->bkrd", p, v) / denom
    return out.reshape(B, H, D).to(q.dtype)


def _check_pools(k_pages, v_pages, k_scales, v_scales) -> bool:
    """True for int8 pools with their scales, False for float pools;
    raises on any other mix."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("paged_decode_attention: k_scales and v_scales "
                         "come together")
    quantized = k_scales is not None
    int8 = (k_pages.dtype == torch.int8, v_pages.dtype == torch.int8)
    if quantized and not all(int8):
        raise ValueError(f"paged_decode_attention: scales given with "
                         f"{k_pages.dtype}/{v_pages.dtype} pools; int8 "
                         "pools take scales")
    if not quantized and any(int8):
        raise ValueError("paged_decode_attention: int8 pools need "
                         "k_scales and v_scales")
    if quantized:
        N, Hkv, ps, _ = k_pages.shape
        for t in (k_scales, v_scales):
            if t.dtype != torch.float32 or tuple(t.shape) != (N, Hkv, 1,
                                                               ps):
                raise ValueError(
                    f"paged_decode_attention: scales {t.dtype} "
                    f"{tuple(t.shape)}; needs float32 {(N, Hkv, 1, ps)}")
    return quantized


def _launch(q, k_pages, v_pages, block_tables, seq_lens, scale,
            k_scales=None, v_scales=None):
    """Run kernel D (float pools) or D' (int8 pools with scales) on CUDA
    tensors; raises on anything it does not take."""
    B, H, D = q.shape
    _, Hkv, ps, _ = k_pages.shape
    quantized = k_scales is not None
    name = "paged_decode_int8" if quantized else "paged_decode"
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name} kernel: head_dim {D} not in "
                         f"{_HEAD_DIMS}")
    if H % Hkv or H // Hkv > _MAX_REP:
        raise ValueError(f"{name} kernel: H={H}, Hkv={Hkv}; needs "
                         f"Hkv | H and H/Hkv <= {_MAX_REP}")
    if q.dtype not in _DTYPES or (not quantized and (
            k_pages.dtype != q.dtype or v_pages.dtype != q.dtype)):
        raise ValueError(f"{name} kernel: dtypes {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}; needs q in "
                         f"{list(_DTYPES)} and pools of q's dtype or int8")
    pools = [k_pages, v_pages] + ([k_scales, v_scales] if quantized else [])
    for t in pools + [block_tables, seq_lens]:
        if t.device != q.device:
            raise ValueError(f"{name} kernel: inputs on different devices")
    if not all(t.is_contiguous() for t in pools):
        raise ValueError(f"{name} kernel: pools must be contiguous")
    if quantized and any(t.data_ptr() % 16 for t in (k_pages, v_pages)):
        raise ValueError(f"{name} kernel: int8 pools must be 16-byte "
                         "aligned")
    if q.stride(-1) != 1:
        q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    lib = cuda_build.library("paged_decode")
    if quantized:
        fn = lib.orion_paged_decode_int8
        ptrs = [q, k_pages, v_pages, k_scales, v_scales, bt, lens, out]
    else:
        fn = lib.orion_paged_decode
        ptrs = [q, k_pages, v_pages, bt, lens, out]
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(*(t.data_ptr() for t in ptrs),
             B, H, Hkv, D, ps, bt.shape[1],
             q.stride(0), q.stride(1), out.stride(0), out.stride(1),
             float(scale), _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, name)
    if quantized:
        paged_decode_attention_int8.launches += 1
    else:
        paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor,
                           block_tables: torch.Tensor,
                           seq_lens: torch.Tensor, scale: float,
                           k_scales=None, v_scales=None) -> torch.Tensor:
    """One decode step of attention over a paged KV pool.

    q [B, H, D] (current token per sequence); k_pages/v_pages
    [num_pages, Hkv, ps, D] in q's dtype — or int8 with ``k_scales`` /
    ``v_scales`` f32 [num_pages, Hkv, 1, ps]; block_tables
    [B, max_pages] int32; seq_lens [B] int32 — valid tokens including
    the current one (a length past max_pages * ps counts only the
    table's pages).  Returns [B, H, D] in q.dtype.  CUDA tensors go
    through kernel D (float pools) or D' (int8 pools); CPU tensors
    through the plain version."""
    _check_pools(k_pages, v_pages, k_scales, v_scales)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pages, v_pages, block_tables, seq_lens, scale,
            k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    return _launch(q, k_pages, v_pages, block_tables, seq_lens, scale,
                   k_scales, v_scales)


def paged_decode_attention_int8(q, k_pages, v_pages, k_scales, v_scales,
                                block_tables, seq_lens,
                                scale: float) -> torch.Tensor:
    """int8-pool entry point (scales required); delegates to
    :func:`paged_decode_attention`."""
    if k_scales is None or v_scales is None:
        raise ValueError("paged_decode_attention_int8: scales required")
    return paged_decode_attention(q, k_pages, v_pages, block_tables,
                                  seq_lens, scale, k_scales=k_scales,
                                  v_scales=v_scales)


# Kernel launches since each count was last set to 0: D's, and D''s.
paged_decode_attention.launches = 0
paged_decode_attention_int8.launches = 0
