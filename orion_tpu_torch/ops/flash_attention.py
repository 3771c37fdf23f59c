"""Causal flash attention: the wrappers around kernel A (forward,
``csrc/flash_fwd.cu``) and kernels B and C (backward,
``csrc/flash_bwd_dq.cu`` and ``csrc/flash_bwd_dkv.cu``), the autograd
Function that joins them, their chunk forms A′, B′ and C′ over explicit
kv positions (the same sources, ``KvPos=true``) for ring attention, and
the plain PyTorch versions of all six.

Replaces ``orion_tpu/ops/pallas/flash_attention.py``: ``_fwd`` /
``_fwd_kernel`` (A), ``_dq_call`` / ``_dq_kernel`` (B) and
``_dkv_call`` / ``_dkv_kernel`` plus ``_bwd_impl``'s GQA group-sum (C),
as reached by ``flash_attention_gqa`` and its ``custom_vjp`` (slot j
holds absolute position j); and the same three with ``use_kvpos=True``
as reached by ``flash_chunk_fwd`` (A′) and ``flash_chunk_grads`` (B′,
C′), where the key in slot j sits at an arbitrary position
``kv_positions[b, j]``.  At the slices' shapes the least time on this
card is set by bytes for A, B and C (~140 flops per byte for A, under
the bf16 balance point) and by operations for the long ring chunks.
A, A′, B and B′ in bf16 run all their products on the tensor cores
(``wgmma``) over tiles loaded by ``cp.async``, so their bf16 q, k and
v must be 16-byte aligned in base and strides (the wrapper raises
otherwise; B and B′ copy an unaligned dO); in f32, and for C and C′,
the kernels compute on the CUDA cores.  All skip every tile that no
query of the q tile can see — see each source's header for its
design.

Each wrapper runs the plain version only for CPU tensors; for a CUDA
tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from orion_tpu_torch.ops import cuda_build

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)


def _plain_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions compute in f32 (f64 for f64 inputs, which
    ``torch.autograd.gradcheck`` needs)."""
    return torch.promote_types(x.dtype, torch.float32)


def _valid(q_positions: torch.Tensor, lk: int,
           kv_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, Lq, Lk] bool: the key in slot j is valid for the query at
    position p iff its position is <= p — slot j itself (position j)
    without ``kv_positions``, else ``kv_positions[b, j]`` [B, Lk]."""
    if kv_positions is None:
        kv_positions = torch.arange(lk, device=q_positions.device)[None]
    kv = kv_positions.to(torch.int64)
    return kv[:, None, :] <= q_positions[:, :, None].to(torch.int64)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, q_positions: torch.Tensor,
                              scale: float, return_lse: bool = False):
    """Plain PyTorch version of kernel A: the same math in one f32 pass.

    q [B, Lq, H, D]; k/v [B, Lk, Hkv, D]; q_positions [B, Lq] int.  The
    query at position p attends kv slot j iff j <= p; head h reads kv
    head h // (H // Hkv).  Returns O [B, Lq, H, D] in q.dtype (and LSE
    [B, H, Lq] f32 with ``return_lse``).  A row with no valid key gives
    O = 0 and LSE ~ -1e30, as the kernel does."""
    out, lse = _forward_plain(q, k, v, q_positions, None, scale)
    return (out, lse) if return_lse else out


def flash_chunk_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, q_positions: torch.Tensor,
                              kv_positions: torch.Tensor, scale: float):
    """Plain PyTorch version of kernel A′: one ring chunk.  As
    :func:`flash_attention_reference`, but the key in slot j sits at
    position ``kv_positions[b, j]`` [B, Lk] (any order) and is valid
    for the query at position p iff that position is <= p.  Returns (O
    [B, Lq, H, D] normalised within the chunk, in q.dtype; LSE
    [B, H, Lq] f32).  A row with no valid key gives O = 0 and
    LSE ~ -1e30 (the JAX kernel gives the mean of V there when another
    row of its q tile has a key; the ring merge weighs either 0)."""
    return _forward_plain(q, k, v, q_positions, kv_positions, scale)


def _forward_plain(q, k, v, q_positions, kv_positions, scale):
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    f = _plain_dtype(q)
    qg = q.reshape(B, Lq, Hkv, g, D).to(f) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(f))
    valid = _valid(q_positions, Lk, kv_positions)[:, None, None, :, :]
    s = s.masked_fill(~valid, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    lsum = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(f))
    out = out / lsum.permute(0, 3, 1, 2, 4)
    out = out.reshape(B, Lq, H, D).to(q.dtype)
    lse = (m + torch.log(lsum)).reshape(B, H, Lq)
    return out, lse


def _backward_plain(q, k, v, q_positions, dout, lse, delta, scale,
                    kv_positions=None):
    """The backward's math in f32, per q-head and then group-summed
    over each GQA group (``_bwd_impl``), with the keys at
    ``kv_positions`` (None: slot j at position j).  Returns (dq, dk,
    dv) in q's, k's and v's dtypes."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    f = _plain_dtype(q)
    qs = q.to(f) * scale
    kr = k.to(f).repeat_interleave(g, dim=2)              # [B, Lk, H, D]
    vr = v.to(f).repeat_interleave(g, dim=2)
    do = dout.to(f)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kr)
    # Masked slots go to -inf before the exp, so a row with no valid key
    # (lse ~ -1e30) gives p = 0, never exp of a huge number.
    s = s.masked_fill(~_valid(q_positions, Lk, kv_positions)[:, None],
                      float("-inf"))
    p = torch.exp(s - lse.to(f)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vr)
    ds = p * (dp - delta.to(f)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)          # carries scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dk = dk.reshape(B, Lk, Hkv, g, D).sum(dim=3)
    dv = dv.reshape(B, Lk, Hkv, g, D).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_delta(out: torch.Tensor, dout: torch.Tensor
                          ) -> torch.Tensor:
    """rowsum(dO * O) [B, H, Lq] in f32 — plain elementwise torch, as the
    JAX package computes it in plain XLA outside Pallas."""
    f = _plain_dtype(out)
    return (dout.to(f) * out.to(f)).sum(dim=-1).transpose(1, 2)


def flash_attention_backward_reference(q, k, v, q_positions, out, lse,
                                       dout, scale):
    """Plain PyTorch version of the whole backward (kernels B and C):
    (dq, dk, dv) for the forward's O [B, Lq, H, D] and LSE [B, H, Lq]
    under the cotangent dout, in f32 per q-head, group-summed, cast to
    the input dtypes.  Used by the tests and by the CPU path only."""
    return _backward_plain(q, k, v, q_positions, dout, lse,
                           flash_attention_delta(out, dout), scale)


def flash_chunk_grads_reference(q, k, v, q_positions, kv_positions, out,
                                lse, dout, scale):
    """Plain PyTorch version of kernels B′ and C′: one ring chunk's
    part of the backward against the GLOBAL softmax statistics — ``lse``
    [B, H, Lq] over every chunk, ``out``/``dout`` the final merged
    output and its cotangent — so p = exp(s − lse) is the chunk's exact
    share of the global attention.  Returns (dq, the chunk's part;
    dk and dv, complete for the chunk's keys and group-summed) in the
    input dtypes."""
    return _backward_plain(q, k, v, q_positions, dout, lse,
                           flash_attention_delta(out, dout), scale,
                           kv_positions)


def _check_inputs(q, k, v, q_positions, kv_positions=None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, Lq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError("flash attention: k/v must be [B, Lk, Hkv, D] "
                         "with Hkv dividing H")
    if q_positions.shape != (B, Lq):
        raise ValueError(f"flash attention: q_positions "
                         f"{tuple(q_positions.shape)} != {(B, Lq)}")
    if kv_positions is not None and kv_positions.shape != k.shape[:2]:
        raise ValueError(f"flash attention: kv_positions "
                         f"{tuple(kv_positions.shape)} != "
                         f"{tuple(k.shape[:2])}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention: unsupported device "
                         f"{q.device}")


def _check_backward_inputs(q, k, v, q_positions, dout, lse, delta,
                           kv_positions=None) -> None:
    _check_inputs(q, k, v, q_positions, kv_positions)
    B, Lq, H, _ = q.shape
    if dout.shape != q.shape:
        raise ValueError(f"flash backward: dout {tuple(dout.shape)} != q "
                         f"{tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Lq):
            raise ValueError(f"flash backward: {name} {tuple(t.shape)} "
                             f"!= {(B, H, Lq)}")


def _kernel_ready(name, q, k, v, *others) -> None:
    """What every kernel of this module refuses: a head dim or dtype it
    has no instance for, mixed devices, a non-contiguous head dim."""
    D = q.shape[3]
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name} kernel: head_dim {D} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} kernel: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; needs one of {list(_DTYPES)}")
    for t in (k, v, *others):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} kernel: inputs on different devices")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name} kernel: head dim must be contiguous")


def _aligned(t: torch.Tensor) -> bool:
    """Base address and batch, sequence and head strides of a bf16
    [B, L, H, D] tensor all multiples of 16 bytes."""
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0
                                          for s in t.stride()[:3])


def _check_aligned(name, q, k, v) -> None:
    """Kernels A, A′, B and B′ read bf16 q, k and v in 16-byte units
    (``cp.async``): each base address and each batch, sequence and head
    stride must be a multiple of 16 bytes.  Raises rather than copying."""
    if q.dtype != torch.bfloat16:
        return
    for which, t in (("q", q), ("k", k), ("v", v)):
        if not _aligned(t):
            raise ValueError(
                f"{name} kernel: bf16 {which} needs a 16-byte aligned base "
                f"and batch/sequence/head strides that are multiples of 8 "
                f"elements (strides {tuple(t.stride())})")


def _positions(*positions):
    """The position operands as the kernels read them: contiguous
    int32, the kv positions left out when there are none."""
    return [p.to(torch.int32).contiguous() for p in positions
            if p is not None]


def _call(name, symbol, ptrs, dims, strides, scale, dtype, stream):
    """Call the ctypes entry ``symbol`` of library ``name`` with the
    tensors (or None) ``ptrs``, the ints (B, Lq, Lk, H, Hkv, D), the
    strides, scale, dtype code and stream; raises on a launch error."""
    fn = getattr(cuda_build.library(name), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * len(strides)
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(*(None if t is None else t.data_ptr() for t in ptrs), *dims,
             *strides, float(scale), _DTYPES[dtype], stream)
    cuda_build.check(err, symbol)


def _launch(q, k, v, q_positions, scale, with_lse, kv_positions=None):
    """Run kernel A, or A′ with ``kv_positions``, on CUDA tensors;
    raises on anything it does not take."""
    chunk = kv_positions is not None
    name = "flash_chunk_fwd" if chunk else "flash_fwd"
    _kernel_ready(name, q, k, v, q_positions, kv_positions)
    _check_aligned(name, q, k, v)
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    pos = _positions(q_positions, kv_positions)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B == 0 or Lq == 0 or H == 0:
        return out, lse
    _call("flash_fwd", "orion_flash_chunk_fwd" if chunk else
          "orion_flash_fwd", [q, k, v, *pos, out, lse],
          (B, Lq, Lk, H, Hkv, D),
          (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *out.stride()[:3]), scale, q.dtype,
          torch.cuda.current_stream(q.device).cuda_stream)
    (flash_chunk_fwd if chunk else flash_attention_gqa).launches += 1
    return out, lse


def _backward_operands(name, q, k, v, q_positions, kv_positions, dout, lse,
                       delta):
    """Checks shared by kernels B, C, B′ and C′; returns the operands as
    the kernels read them.  q, k, v and dout are read through their
    strides (head dim contiguous); a dout whose head dim is strided
    (autograd may hand one over) is copied contiguous.  Positions, LSE
    and delta are made contiguous int32 / f32."""
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    if dout.dtype != q.dtype:
        raise ValueError(f"{name} kernel: dout dtype {dout.dtype} != q "
                         f"dtype {q.dtype}")
    _kernel_ready(name, q, k, v, q_positions, kv_positions, dout, lse,
                  delta)
    return (dout, _positions(q_positions, kv_positions),
            lse.to(torch.float32).contiguous(),
            delta.to(torch.float32).contiguous())


def _launch_dq(q, k, v, q_positions, kv_positions, dout, lse, delta, scale):
    """Run kernel B, or B′ with ``kv_positions``."""
    chunk = kv_positions is not None
    name = "flash_chunk_bwd_dq" if chunk else "flash_bwd_dq"
    dout, pos, lse, delta = _backward_operands(
        name, q, k, v, q_positions, kv_positions, dout, lse, delta)
    _check_aligned(name, q, k, v)
    if dout.dtype == torch.bfloat16 and not _aligned(dout):
        dout = dout.clone(memory_format=torch.contiguous_format)
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if dq.numel() == 0:
        return dq
    _call("flash_bwd_dq", f"orion_{name}",
          [q, k, v, dout, *pos, lse, delta, dq], (B, Lq, Lk, H, Hkv, D),
          (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *dout.stride()[:3], *dq.stride()[:3]), scale, q.dtype,
          torch.cuda.current_stream(q.device).cuda_stream)
    (flash_chunk_bwd_dq if chunk else flash_bwd_dq).launches += 1
    return dq


def _launch_dkv(q, k, v, q_positions, kv_positions, dout, lse, delta,
                scale):
    """Run kernel C, or C′ with ``kv_positions``."""
    chunk = kv_positions is not None
    name = "flash_chunk_bwd_dkv" if chunk else "flash_bwd_dkv"
    dout, pos, lse, delta = _backward_operands(
        name, q, k, v, q_positions, kv_positions, dout, lse, delta)
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    if dk.numel() == 0:
        return dk, dv
    if Lq == 0:
        return dk.zero_(), dv.zero_()
    _call("flash_bwd_dkv", f"orion_{name}",
          [q, k, v, dout, *pos, lse, delta, dk, dv], (B, Lq, Lk, H, Hkv, D),
          (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
           *dout.stride()[:3], *dk.stride()[:3], *dv.stride()[:3]), scale,
          q.dtype, torch.cuda.current_stream(q.device).cuda_stream)
    (flash_chunk_bwd_dkv if chunk else flash_bwd_dkv).launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, q_positions, dout, lse, delta, scale):
    """dQ [B, Lq, H, D] in q.dtype (kernel B): with P = exp(q·scale·Kᵀ −
    LSE) on the valid slots, dP = dO·Vᵀ and dS = P∘(dP − delta),
    dQ = scale·dS·K.  CUDA tensors go through kernel B; CPU tensors
    through the plain version."""
    _check_backward_inputs(q, k, v, q_positions, dout, lse, delta)
    if q.device.type == "cpu":
        return _backward_plain(q, k, v, q_positions, dout, lse, delta,
                               scale)[0]
    return _launch_dq(q, k, v, q_positions, None, dout, lse, delta, scale)


def flash_bwd_dkv(q, k, v, q_positions, dout, lse, delta, scale):
    """(dK, dV) [B, Lk, Hkv, D] in k's / v's dtype (kernel C): dV =
    Σ_i Pᵀ·dO and dK = Σ_i dSᵀ·(q·scale), summed over the query heads of
    each GQA group.  CUDA tensors go through kernel C; CPU tensors
    through the plain version."""
    _check_backward_inputs(q, k, v, q_positions, dout, lse, delta)
    if q.device.type == "cpu":
        return _backward_plain(q, k, v, q_positions, dout, lse, delta,
                               scale)[1:]
    return _launch_dkv(q, k, v, q_positions, None, dout, lse, delta, scale)


class FlashAttention(torch.autograd.Function):
    """``flash_attention_gqa`` under autograd (the JAX ``custom_vjp``:
    ``_vjp_fwd`` / ``_vjp_bwd``).  Forward: kernel A with LSE (the plain
    version on the CPU), saving q, k, v, positions, O and LSE.
    Backward: delta = rowsum(dO ∘ O) in f32, then kernels B and C (the
    plain versions on the CPU).  Returns (O, LSE); LSE carries no
    gradient.  ``custom_fwd``/``custom_bwd`` run the backward under the
    forward's autocast state."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, q_positions, scale):
        if q.device.type == "cpu":
            out, lse = flash_attention_reference(q, k, v, q_positions,
                                                 scale, return_lse=True)
        else:
            out, lse = _launch(q, k, v, q_positions, scale, True)
        ctx.save_for_backward(q, k, v, q_positions, out, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dout, _dlse):
        q, k, v, q_positions, out, lse = ctx.saved_tensors
        delta = flash_attention_delta(out, dout)
        dq = flash_bwd_dq(q, k, v, q_positions, dout, lse, delta,
                          ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, q_positions, dout, lse, delta,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        q_positions: torch.Tensor, scale: float,
                        return_lse: bool = False):
    """Causal flash attention with positional masking.

    q [B, Lq, H, D]; k/v [B, Lk, Hkv, D] (Hkv divides H); q_positions
    [B, Lq] absolute positions — the query at position p attends kv
    slots j <= p.  Returns [B, Lq, H, D] in q.dtype (plus LSE [B, H, Lq]
    f32 with ``return_lse``).  CUDA tensors go through kernel A (D in
    64/128/256, bf16 or f32); CPU tensors through the plain version.
    When grad is enabled and q, k or v requires it, the call goes
    through :class:`FlashAttention`, whose backward is kernels B and
    C."""
    _check_inputs(q, k, v, q_positions)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = FlashAttention.apply(q, k, v, q_positions, scale)
    elif q.device.type == "cpu":
        out, lse = flash_attention_reference(q, k, v, q_positions, scale,
                                             return_lse=True)
    else:
        out, lse = _launch(q, k, v, q_positions, scale, return_lse)
    return (out, lse) if return_lse else out


def flash_chunk_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    scale: float):
    """One ring chunk (kernel A′; ``flash_chunk_fwd`` of the JAX
    package): q [B, Lq, H, D] at positions ``q_positions`` [B, Lq]
    against k/v [B, Lk, Hkv, D] at arbitrary positions
    ``kv_positions`` [B, Lk]; a key is valid for a query iff its
    position is <= the query's.  Returns (O [B, Lq, H, D] normalised
    within the chunk, in q.dtype; LSE [B, H, Lq] f32); a row with no
    valid key gives O = 0 and LSE ~ -1e30.  No autograd: the ring's
    own Function owns the backward (:func:`flash_chunk_grads`).  CUDA
    tensors go through kernel A′ (D in 64/128/256, bf16 or f32); CPU
    tensors through the plain version."""
    _check_inputs(q, k, v, q_positions, kv_positions)
    if q.device.type == "cpu":
        return flash_chunk_fwd_reference(q, k, v, q_positions, kv_positions,
                                         scale)
    return _launch(q, k, v, q_positions, scale, True, kv_positions)


def flash_chunk_bwd_dq(q, k, v, q_positions, kv_positions, dout, lse, delta,
                       scale):
    """The chunk's part of dQ (kernel B′): :func:`flash_bwd_dq` with the
    keys at ``kv_positions``, against the caller's (global) ``lse`` and
    ``delta``.  CPU tensors go through the plain version."""
    _check_backward_inputs(q, k, v, q_positions, dout, lse, delta,
                           kv_positions)
    if q.device.type == "cpu":
        return _backward_plain(q, k, v, q_positions, dout, lse, delta,
                               scale, kv_positions)[0]
    return _launch_dq(q, k, v, q_positions, kv_positions, dout, lse, delta,
                      scale)


def flash_chunk_bwd_dkv(q, k, v, q_positions, kv_positions, dout, lse,
                        delta, scale):
    """The chunk's dK and dV, group-summed (kernel C′):
    :func:`flash_bwd_dkv` with the keys at ``kv_positions``, against the
    caller's (global) ``lse`` and ``delta``.  CPU tensors go through the
    plain version."""
    _check_backward_inputs(q, k, v, q_positions, dout, lse, delta,
                           kv_positions)
    if q.device.type == "cpu":
        return _backward_plain(q, k, v, q_positions, dout, lse, delta,
                               scale, kv_positions)[1:]
    return _launch_dkv(q, k, v, q_positions, kv_positions, dout, lse, delta,
                       scale)


def flash_chunk_grads(q, k, v, q_positions, kv_positions, out, lse, dout,
                      scale):
    """One ring chunk's backward (``flash_chunk_grads`` of the JAX
    package): delta = rowsum(dO ∘ O) in plain torch from the FINAL
    merged ``out`` and its cotangent ``dout``, then kernel B′ (dq, this
    chunk's part) and kernel C′ (dk, dv, complete for the chunk's keys)
    against the GLOBAL ``lse`` [B, H, Lq].  Returns (dq, dk, dv) in the
    input dtypes; CPU tensors go through the plain versions."""
    _check_inputs(q, k, v, q_positions, kv_positions)
    delta = flash_attention_delta(out, dout)
    return (flash_chunk_bwd_dq(q, k, v, q_positions, kv_positions, dout,
                               lse, delta, scale),
            *flash_chunk_bwd_dkv(q, k, v, q_positions, kv_positions, dout,
                                 lse, delta, scale))


# Kernel launches since each count was last set to 0.
flash_attention_gqa.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
flash_chunk_fwd.launches = 0
flash_chunk_bwd_dq.launches = 0
flash_chunk_bwd_dkv.launches = 0
