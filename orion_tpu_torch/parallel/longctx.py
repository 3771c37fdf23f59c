"""Long-context sequence parallelism (port of
``orion_tpu/parallel/longctx.py``): ring attention with its zigzag
layout, and Ulysses.

The JAX package runs both inside a ``shard_map`` over the mesh's
``seq`` axis of s devices: rank i holds shard i of the sequence, and
``lax.ppermute`` sends rank i's tensors to rank i + 1.  The port states
that contract once, as a ring object passed to the ring functions: it
has ``size`` and ``rotate(*tensors)``, which returns what each rank
receives from rank - 1.  :class:`StackedRing` is its one implementation
here: all s shards side by side on one device, with the rank axis
folded into the batch, rank-major (``[s·B, L/s, ...]``).  It is the
port's counterpart of the JAX tests' fake-CPU-device mesh, and how one
card runs s shards.  A ring over ``torch.distributed`` processes is
later work (ROADMAP.md, module 11).

- **Ring attention** (:func:`ring_attention`): queries stay put; k, v
  and their positions rotate around the ring.  Each step runs one
  chunk through kernel A′ (``flash_chunk_fwd``) and merges its
  chunk-normalised (O, LSE) by streaming softmax in f32.  The backward
  rotates k and v again and runs kernels B′ and C′
  (``flash_chunk_grads``) against the GLOBAL LSE; the dk/dv
  accumulators travel the ring with their chunks and arrive home.
- **Ulysses** (:func:`ulysses_attention`): the all-to-all swaps the
  sharded axis from sequence to head groups, the local attention runs
  over the full sequence through kernel A (``flash_attention_gqa``),
  and the result is swapped back.
- **Zigzag** (:func:`zigzag_order`): rank d holds chunks (d, 2s-1-d),
  so every rank does the same causal work.  The attention functions
  take absolute positions, so the layout is a permutation of tokens
  and positions before sharding.

:func:`sequence_parallel` makes a ring the active one for
``attention(impl="ring" | "ulysses")`` (the counterpart of
``shard_map``'s axis environment), so a whole model runs sequence
parallel through its usual forward.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, Optional

import numpy as np
import torch

from orion_tpu_torch.ops.flash_attention import (_check_inputs,
                                                 flash_attention_gqa,
                                                 flash_chunk_fwd,
                                                 flash_chunk_grads)

_NEG_INF = -1e30


class StackedRing:
    """A ring of ``size`` ranks whose shards lie side by side on one
    device: every tensor the ring functions take carries the rank axis
    folded into its leading (batch) axis, rank-major, so rank r's batch
    b sits at row ``r·B + b`` of ``[size·B, ...]``."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"ring size {size} < 1")
        self.size = int(size)

    def _ranks(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % self.size:
            raise ValueError(f"leading axis {x.shape[0]} is not a multiple "
                             f"of the ring size {self.size}")
        return x.reshape(self.size, x.shape[0] // self.size, *x.shape[1:])

    def rotate(self, *tensors: torch.Tensor):
        """Each rank's tensors as rank - 1 holds them (``lax.ppermute``
        with perm ``i -> i + 1``).  Returns new contiguous tensors, one
        per argument (a tuple for several, the tensor for one)."""
        out = tuple(torch.roll(self._ranks(t), 1, dims=0).reshape(t.shape)
                    for t in tensors)
        return out if len(out) != 1 else out[0]

    def shard(self, x: torch.Tensor, zigzag: bool = True) -> torch.Tensor:
        """[B, L, ...] -> [size·B, L/size, ...]: rank r takes the r-th
        slice of the sequence (after the zigzag permutation with
        ``zigzag``), as ``shard_map``'s ``in_specs=P(None, "seq")``."""
        B, L = x.shape[:2]
        if zigzag:
            x = x[:, torch.from_numpy(zigzag_order(L, self.size)).to(
                x.device)]
        elif L % self.size:
            raise ValueError(f"sequence {L} not divisible by the ring size "
                             f"{self.size}")
        x = x.reshape(B, self.size, L // self.size, *x.shape[2:])
        return x.transpose(0, 1).reshape(self.size * B, L // self.size,
                                         *x.shape[3:])

    def unshard(self, y: torch.Tensor, zigzag: bool = True) -> torch.Tensor:
        """The inverse of :meth:`shard` (``out_specs=P(None, "seq")``,
        then the inverse zigzag permutation with ``zigzag``)."""
        y = self._ranks(y)
        B, Ls = y.shape[1], y.shape[2]
        L = self.size * Ls
        y = y.transpose(0, 1).reshape(B, L, *y.shape[3:])
        if zigzag:
            y = y[:, torch.from_numpy(zigzag_inverse(L, self.size)).to(
                y.device)]
        return y


_ACTIVE: contextvars.ContextVar[Optional[StackedRing]] = \
    contextvars.ContextVar("orion_tpu_torch_ring", default=None)


@contextlib.contextmanager
def sequence_parallel(ring: StackedRing) -> Iterator[StackedRing]:
    """Make ``ring`` the active ring for ``attention(impl="ring" |
    "ulysses")`` inside the block (the port's counterpart of running
    inside ``shard_map`` over the ``seq`` axis); the previous ring is
    restored on exit."""
    token = _ACTIVE.set(ring)
    try:
        yield ring
    finally:
        _ACTIVE.reset(token)


def active_ring(impl: str) -> StackedRing:
    """The ring of the enclosing :func:`sequence_parallel`; raises
    outside one."""
    ring = _ACTIVE.get()
    if ring is None:
        raise RuntimeError(
            f"attention impl {impl!r} needs an active ring: run the model "
            "inside orion_tpu_torch.parallel.sequence_parallel(ring)")
    return ring


# ---------------------------------------------------------------------------
# Ulysses: seq-shard -> head-shard -> attend -> back
# ---------------------------------------------------------------------------


def _seq_to_heads(x: torch.Tensor, s: int) -> torch.Tensor:
    """[s·B, Ls, H, D] sharded on the sequence -> [s·B, L, H/s, D]
    sharded on heads: new rank g holds head group g of every rank's
    slice, the slices concatenated in rank order (``all_to_all``,
    split_axis=2, concat_axis=1, tiled)."""
    sB, Ls, H, D = x.shape
    x = x.reshape(s, sB // s, Ls, s, H // s, D)      # src, b, l, g, h, d
    return x.permute(3, 1, 0, 2, 4, 5).reshape(sB, s * Ls, H // s, D)


def _heads_to_seq(x: torch.Tensor, s: int) -> torch.Tensor:
    """The inverse of :func:`_seq_to_heads`."""
    sB, L, Hs, D = x.shape
    x = x.reshape(s, sB // s, s, L // s, Hs, D)      # g, b, src, l, h, d
    return x.permute(2, 1, 3, 0, 4, 5).reshape(sB, L // s, s * Hs, D)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_positions: torch.Tensor, scale: float,
                      ring: StackedRing) -> torch.Tensor:
    """Ulysses attention over ``ring``.  q [s·B, Ls, H, D], k/v
    [s·B, Ls, Hkv, D], q_positions [s·B, Ls], all sharded on the
    sequence.  After the swap each rank holds the full sequence for
    H/s heads, and the local attention is kernel A's positional rule
    (kv slot j <= query position), so the layout must be contiguous,
    as in the JAX package.  Returns [s·B, Ls, H, D]."""
    s = ring.size
    H, Hkv = q.shape[2], k.shape[2]
    if H % s or Hkv % s:
        raise ValueError(
            f"ulysses needs ring size {s} to divide heads {H} and kv "
            f"heads {Hkv}; use ring_attention instead")
    qh, kh, vh = (_seq_to_heads(t, s) for t in (q, k, v))
    # all_gather of the positions: every new rank sees all slices.
    pos = ring._ranks(q_positions).transpose(0, 1).reshape(
        q_positions.shape[0] // s, -1)
    pos = pos.repeat(s, 1)
    out = flash_attention_gqa(qh, kh, vh, pos, scale)
    return _heads_to_seq(out, s)


# ---------------------------------------------------------------------------
# Ring attention: KV rotates, queries stay
# ---------------------------------------------------------------------------


def ring_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, q_positions: torch.Tensor,
                             kv_positions: torch.Tensor, scale: float,
                             ring: StackedRing) -> torch.Tensor:
    """Dense-per-chunk ring attention: each rotation's full [B, H, Lq,
    Lk] f32 score block, merged by streaming softmax.  Exact; the
    numerics oracle for :func:`ring_attention` in the tests."""
    s = ring.size
    B, Lq, H, D = q.shape
    n_rep = H // k.shape[2]
    qf = q.to(torch.float32) * scale
    m = torch.full((B, H, Lq, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)
    for _ in range(s):
        kk = k.to(torch.float32).repeat_interleave(n_rep, dim=2)
        vv = v.to(torch.float32).repeat_interleave(n_rep, dim=2)
        sc = torch.einsum("bqhd,bkhd->bhqk", qf, kk)
        mask = (kv_positions[:, None, None, :].to(torch.int64)
                <= q_positions[:, None, :, None].to(torch.int64))
        sc = torch.where(mask, sc, torch.full_like(sc, _NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p, vv)
        m = m_new
        k, v, kv_positions = ring.rotate(k, v, kv_positions)
    out = acc / torch.clamp(l, min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _ring_forward(q, k, v, q_positions, kv_positions, scale, ring):
    """s chunk steps through A′, merged in f32; returns (O in q.dtype,
    global LSE [B, Lq, H] f32).  k, v and kv_positions rotate between
    steps, never after the last one."""
    B, Lq, H, D = q.shape
    m = torch.full((B, Lq, H), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Lq, H, D), dtype=torch.float32, device=q.device)
    k_r, v_r, kvp_r = k, v, kv_positions
    for step in range(ring.size):
        o_i, lse_i = flash_chunk_fwd(q, k_r, v_r, q_positions, kvp_r, scale)
        lse_i = lse_i.transpose(1, 2)                     # [B, Lq, H]
        m_new = torch.maximum(m, lse_i)
        w_old = torch.exp(m - m_new)
        w_i = torch.exp(lse_i - m_new)
        acc = acc * w_old[..., None] + o_i.to(torch.float32) * w_i[..., None]
        l = l * w_old + w_i
        m = m_new
        if step < ring.size - 1:
            k_r, v_r, kvp_r = ring.rotate(k_r, v_r, kvp_r)
    l = torch.clamp(l, min=1e-30)
    out = (acc / l[..., None]).to(q.dtype)
    return out, m + torch.log(l)


class RingAttention(torch.autograd.Function):
    """:func:`ring_attention` under autograd (the JAX ``custom_vjp``:
    ``_ring_vjp_fwd`` / ``_ring_vjp_bwd``).  The ring is kept in ``ctx``:
    the backward runs outside any :func:`sequence_parallel` block."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, q_positions, kv_positions, scale, ring):
        out, glse = _ring_forward(q, k, v, q_positions, kv_positions, scale,
                                  ring)
        ctx.save_for_backward(q, k, v, q_positions, kv_positions, out, glse)
        ctx.scale, ctx.ring = scale, ring
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dout):
        q, k, v, q_positions, kv_positions, out, glse = ctx.saved_tensors
        ring = ctx.ring
        glse_t = glse.transpose(1, 2).contiguous()        # [B, H, Lq]
        # f32 accumulators: summing s chunk contributions in bf16 would
        # lose mantissa every step; cast once on return.
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk_r = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv_r = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_r, v_r, kvp_r = k, v, kv_positions
        for step in range(ring.size):
            dq_i, dk_i, dv_i = flash_chunk_grads(
                q, k_r, v_r, q_positions, kvp_r, out, glse_t, dout,
                ctx.scale)
            dq += dq_i
            dk_r += dk_i
            dv_r += dv_i
            # dk/dv travel WITH their chunk and need all s rotations to
            # arrive home; k, v and their positions feed only the next
            # step, so their last rotation is skipped.
            if step < ring.size - 1:
                k_r, v_r, kvp_r = ring.rotate(k_r, v_r, kvp_r)
            dk_r, dv_r = ring.rotate(dk_r, dv_r)
        return (dq.to(q.dtype), dk_r.to(k.dtype), dv_r.to(v.dtype), None,
                None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_positions: torch.Tensor, kv_positions: torch.Tensor,
                   scale: float, ring: StackedRing) -> torch.Tensor:
    """Flash-blockwise ring attention over ``ring``.

    q [s·B, Lq_loc, H, D]; k/v [s·B, Lk_loc, Hkv, D]; q_positions /
    kv_positions [s·B, L*_loc] absolute positions in any layout
    (contiguous or zigzag); a key is valid for a query iff its position
    is <= the query's.  Each of the s steps runs one chunk through
    kernel A′ (its plain version for CPU tensors) and the backward runs
    kernels B′ and C′ against the global LSE.  Returns [s·B, Lq_loc, H,
    D] in q.dtype."""
    _check_inputs(q, k, v, q_positions, kv_positions)
    return RingAttention.apply(q, k, v, q_positions, kv_positions, scale,
                               ring)


# ---------------------------------------------------------------------------
# Zigzag layout helpers (host-side)
# ---------------------------------------------------------------------------


def zigzag_order(L: int, s: int) -> np.ndarray:
    """Token order such that an even split over s ranks gives rank d
    chunks (d, 2s-1-d) of the original sequence — equal causal work per
    rank.  Returns indices [L]: position j of the reordered sequence
    holds original token zigzag_order[j]."""
    if L % (2 * s):
        raise ValueError(f"sequence {L} not divisible by 2*seq axis {2 * s}")
    c = L // (2 * s)
    chunks = []
    for d in range(s):
        chunks.append(np.arange(d * c, (d + 1) * c))
        chunks.append(np.arange((2 * s - 1 - d) * c, (2 * s - d) * c))
    return np.concatenate(chunks)


def zigzag_inverse(L: int, s: int) -> np.ndarray:
    order = zigzag_order(L, s)
    inv = np.empty(L, np.int64)
    inv[order] = np.arange(L)
    return inv
