"""Paged-KV decode attention: the wrapper around kernel D
(``csrc/paged_decode.cu``) and its plain PyTorch version.

Replaces ``orion_tpu/ops/pallas/paged_attention.py``
``paged_decode_attention`` / ``_decode_kernel`` over bf16/f32 pools.
On this card the kernel is bounded by bytes (each valid K/V row is
read once per step for a few flops per byte); its block serves all
query heads of one kv head so every page is read once — see the
source's header for the design.  The int8-pool form (``k_scales`` /
``v_scales``) is not ported yet and raises on CUDA.

The wrapper runs the plain version only for CPU tensors; for a CUDA
tensor it launches the kernel or raises.
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
                                     scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel D (gather + masked softmax in
    f32), mirroring ``paged_decode_attention_reference`` of the JAX
    package: head h reads kv head h // n_rep, slots idx >= seq_len are
    masked, the normaliser is clamped at 1e-30.  Returns [B, H, D] in
    q.dtype."""
    B, H, D = q.shape
    _, Hkv, ps, _ = k_pages.shape
    mp = block_tables.shape[1]
    n_rep = H // Hkv
    bt = block_tables.to(torch.int64)

    def gather(pages):                      # -> [B, Hkv, mp*ps, D] f32
        g = pages[bt]                       # [B, mp, Hkv, ps, D]
        return (g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, mp * ps, D)
                .to(torch.float32))

    k = gather(k_pages)
    v = gather(v_pages)
    qh = q.reshape(B, Hkv, n_rep, D).to(torch.float32) * scale
    s = torch.einsum("bkrd,bksd->bkrs", qh, k)
    idx = torch.arange(mp * ps, device=q.device)
    valid = idx[None, None, None, :] < seq_lens.to(idx.dtype)[
        :, None, None, None]
    s = torch.where(valid, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkrs,bksd->bkrd", p, v) / denom
    return out.reshape(B, H, D).to(q.dtype)


def _launch(q, k_pages, v_pages, block_tables, seq_lens, scale):
    """Run kernel D on CUDA tensors; raises on anything it does not take."""
    B, H, D = q.shape
    _, Hkv, ps, _ = k_pages.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode kernel: head_dim {D} not in "
                         f"{_HEAD_DIMS}")
    if H % Hkv or H // Hkv > _MAX_REP:
        raise ValueError(f"paged_decode kernel: H={H}, Hkv={Hkv}; needs "
                         f"Hkv | H and H/Hkv <= {_MAX_REP}")
    if (q.dtype not in _DTYPES or k_pages.dtype != q.dtype
            or v_pages.dtype != q.dtype):
        raise ValueError(f"paged_decode kernel: dtypes {q.dtype}, "
                         f"{k_pages.dtype}, {v_pages.dtype}; needs one of "
                         f"{list(_DTYPES)}")
    for t in (k_pages, v_pages, block_tables, seq_lens):
        if t.device != q.device:
            raise ValueError("paged_decode kernel: inputs on different "
                             "devices")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("paged_decode kernel: pools must be contiguous")
    if q.stride(-1) != 1:
        q = q.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    fn = cuda_build.library("paged_decode").orion_paged_decode
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             bt.data_ptr(), lens.data_ptr(), out.data_ptr(),
             B, H, Hkv, D, ps, bt.shape[1],
             q.stride(0), q.stride(1), out.stride(0), out.stride(1),
             float(scale), _DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "paged_decode")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor,
                           block_tables: torch.Tensor,
                           seq_lens: torch.Tensor, scale: float,
                           k_scales=None, v_scales=None) -> torch.Tensor:
    """One decode step of attention over a paged KV pool.

    q [B, H, D] (current token per sequence); k_pages/v_pages
    [num_pages, Hkv, ps, D]; block_tables [B, max_pages] int32; seq_lens
    [B] int32 — valid tokens including the current one (a length past
    max_pages * ps counts only the table's pages).  Returns
    [B, H, D] in q.dtype.  CUDA tensors go through kernel D; CPU tensors
    through the plain version."""
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "int8 KV pools (k_scales/v_scales) are not ported yet")
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pages, v_pages, block_tables, seq_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    return _launch(q, k_pages, v_pages, block_tables, seq_lens, scale)


# Kernel launches since the count was last set to 0.
paged_decode_attention.launches = 0
