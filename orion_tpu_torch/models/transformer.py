"""The decoder-only transformer (port of
``orion_tpu/models/transformer.py``: the unrolled model, no MoE, no
int8 dense, no scan).

- ``arch="llama"``: RMSNorm, SwiGLU MLP, full rotary, optional GQA.
- ``arch="neox"``: LayerNorm with bias, parallel attention+MLP residual,
  partial rotary, biased projections, exact GELU.

Every module computes in ``cfg.dtype`` whatever dtype its weights are
stored in: each weight is cast at use (flax ``Dense(dtype=bf16,
param_dtype=f32)``; no autocast).  A serving model stores its weights
in ``cfg.dtype`` — the JAX engine casts its f32 master tree to the
compute dtype once at load — so there every cast is a no-op; a
trainer's policy stores them in ``cfg.param_dtype`` (f32 masters, bf16
compute) and gradients flow back through the casts.  The
forward takes an optional paged cache — a per-layer list of
``{"k_pages", "v_pages", "block_tables"}`` — written IN PLACE: Lq == 1
decodes through the paged kernel (kernel D), Lq > 1 prefills through
the gathered pages and ``attention()`` (kernel A on CUDA).  Logits come
back in f32.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from orion_tpu_torch.config import ModelConfig
from orion_tpu_torch.device import resolve_device, torch_dtype
from orion_tpu_torch.ops.attention import attention
from orion_tpu_torch.ops.paged_attention import paged_decode_attention
from orion_tpu_torch.ops.paged_kv import (gather_paged_kv, is_paged,
                                          write_paged_tokens)
from orion_tpu_torch.ops.rotary import apply_rotary


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (input, weight and
    bias cast at use)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 compute_dtype: torch.dtype, **kw):
        super().__init__(in_features, out_features, bias=bias, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose weight and bias are cast to the input's
    dtype at use (PyTorch's kernel takes its statistics in f32)."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class RMSNorm(nn.Module):
    """RMSNorm computed in f32, cast back (flax ``nn.RMSNorm``)."""

    def __init__(self, dim: int, eps: float, **kw):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **kw))

    def forward(self, x):
        x32 = x.to(torch.float32)
        y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.to(torch.float32)).to(x.dtype)


def _norm(cfg: ModelConfig, **kw) -> nn.Module:
    if cfg.arch == "llama":
        return RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
    return LayerNorm(cfg.hidden_size, eps=cfg.layernorm_eps, **kw)


def _linear(cfg: ModelConfig, in_features: int, out_features: int,
            bias: bool, **kw) -> Linear:
    return Linear(in_features, out_features, bias,
                  torch_dtype(cfg.dtype), **kw)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.cfg = cfg
        H, Hkv, D, E = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                        cfg.hidden_size)
        self.q_proj = _linear(cfg, E, H * D, cfg.attn_bias, **kw)
        self.k_proj = _linear(cfg, E, Hkv * D, cfg.attn_bias, **kw)
        self.v_proj = _linear(cfg, E, Hkv * D, cfg.attn_bias, **kw)
        self.o_proj = _linear(cfg, H * D, E, cfg.attn_bias, **kw)

    def forward(self, x, positions, layer_cache: Optional[dict] = None):
        """x [B, L, E]; positions [B, L] absolute positions.  With a
        paged ``layer_cache`` the L new keys/values are written at
        their positions first (one formula for prefill and decode)."""
        cfg = self.cfg
        B, L, _ = x.shape
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = self.q_proj(x).reshape(B, L, H, D)
        k = self.k_proj(x).reshape(B, L, Hkv, D)
        v = self.v_proj(x).reshape(B, L, Hkv, D)
        rotary_dim = int(D * cfg.rotary_pct)
        q, k = apply_rotary(q, k, positions, rotary_dim, cfg.rope_theta)
        scale = 1.0 / D ** 0.5
        if is_paged(layer_cache):
            write_paged_tokens(layer_cache, k, v, positions)
            if L == 1:
                out = paged_decode_attention(
                    q[:, 0], layer_cache["k_pages"], layer_cache["v_pages"],
                    layer_cache["block_tables"], positions[:, 0] + 1,
                    scale)[:, None]
                return self.o_proj(out.reshape(B, L, H * D))
            # Prefill: slot j of the gathered pages holds position j,
            # so the positional mask covers history and new keys alike.
            keys, values = gather_paged_kv(layer_cache)
        elif layer_cache is not None:
            raise ValueError("the port supports the paged cache only")
        else:
            keys, values = k, v
        # The positional rule kv_slot <= position covers every path;
        # attention() builds the mask only where it needs one.
        out = attention(q, keys, values, None, scale=scale,
                        impl=cfg.attention_impl, q_positions=positions)
        return self.o_proj(out.reshape(B, L, H * D))


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.arch = cfg.arch
        E, I = cfg.hidden_size, cfg.intermediate_size
        if cfg.arch == "llama":
            self.gate_proj = _linear(cfg, E, I, cfg.mlp_bias, **kw)
        self.up_proj = _linear(cfg, E, I, cfg.mlp_bias, **kw)
        self.down_proj = _linear(cfg, I, E, cfg.mlp_bias, **kw)

    def forward(self, x):
        if self.arch == "llama":
            return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
        return self.down_proj(F.gelu(self.up_proj(x), approximate="none"))


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.parallel = cfg.use_parallel_residual
        self.input_norm = _norm(cfg, **kw)
        self.post_attn_norm = _norm(cfg, **kw)
        self.attn = Attention(cfg, **kw)
        self.mlp = MLP(cfg, **kw)

    def forward(self, x, positions, layer_cache=None):
        attn_out = self.attn(self.input_norm(x), positions, layer_cache)
        if self.parallel:
            # GPT-NeoX: x + attn(ln1(x)) + mlp(ln2(x))
            return x + attn_out + self.mlp(self.post_attn_norm(x))
        h = x + attn_out
        return h + self.mlp(self.post_attn_norm(h))


class Transformer(nn.Module):
    """Backbone + LM head.  ``forward`` returns f32 logits [B, L, V]
    (or [B, T, V] at ``logits_positions`` [B, T]).

    ``device=None`` means the card (raises without one); tests pass
    ``device="cpu"``.  ``dtype`` is the weights' storage dtype: default
    ``cfg.dtype`` (a serving copy); a trainer's policy passes
    ``cfg.param_dtype``.  Compute runs in ``cfg.dtype`` either way.  The
    weights are a seeded random init (``seed``, drawn by the device's
    own generator, so CPU and CUDA draws differ), as the JAX package's
    ``init_params`` draws them: normal(0.02) projections and
    embeddings, zero biases, unit norm scales."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        # Built on the meta device and materialised empty, so module
        # construction draws nothing from the global RNG; the weights
        # come from reset_parameters' own generator.
        kw = {"device": "meta", "dtype": dtype or torch_dtype(cfg.dtype)}
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.final_norm = _norm(cfg, **kw)
        self.lm_head = (None if cfg.tie_word_embeddings else
                        _linear(cfg, cfg.hidden_size, cfg.vocab_size,
                                False, **kw))
        self.to_empty(device=dev)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int) -> None:
        gen = torch.Generator(device=self.embed.weight.device)
        gen.manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (Linear, nn.Embedding)):
                mod.weight.normal_(0.0, 0.02, generator=gen)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (LayerNorm, RMSNorm)):
                mod.weight.fill_(1.0)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()

    def forward(self, input_ids: torch.Tensor, positions: torch.Tensor,
                cache: Optional[List[dict]] = None,
                logits_positions: Optional[torch.Tensor] = None):
        x = self.embed(input_ids).to(torch_dtype(self.cfg.dtype))
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, cache[i] if cache is not None else None)
        x = self.final_norm(x)
        if logits_positions is not None:
            idx = logits_positions.to(torch.int64)[..., None].expand(
                -1, -1, x.shape[-1])
            x = torch.gather(x, 1, idx)
        if self.lm_head is None:
            logits = x @ self.embed.weight.to(x.dtype).T
        else:
            logits = self.lm_head(x)
        return logits.to(torch.float32)
