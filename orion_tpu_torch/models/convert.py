"""Cross the JAX package's parameter tree into the port's modules.

The tree is the flax ``params`` dict as numpy arrays (a caller holding
JAX arrays passes ``jax.tree.map(np.asarray, params)``; this module
imports nothing of JAX).  Flax ``Dense.kernel`` is [in, out] and
``nn.Linear.weight`` is [out, in], so projections are transposed;
norm ``scale`` becomes ``weight``; the embedding table is taken as is.
A tree from ``quantize_params_int8`` (the ``QuantDense`` layout
``{kernel_q, scale, bias?}``) loads into a model built with
``quantize_dense=True``: ``kernel_q`` transposed into ``weight_q``,
the per-output-channel ``scale`` as it is.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from orion_tpu_torch.config import ModelConfig
from orion_tpu_torch.models.transformer import Transformer


def _copy(dst: torch.Tensor, src, transpose: bool = False) -> None:
    arr = np.array(src, dtype=np.float32)  # a writable copy
    if transpose:
        arr = arr.T
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"shape {arr.shape} does not fit parameter "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.ascontiguousarray(arr)))


def _load_dense(linear: torch.nn.Module, node: Mapping) -> None:
    if ("kernel_q" in node) != hasattr(linear, "weight_q"):
        raise ValueError("an int8 (QuantDense) tree loads into a model "
                         "built with quantize_dense=True, and only there")
    if "kernel_q" in node:
        # int8 values are exact in f32, so _copy's f32 trip keeps them.
        _copy(linear.weight_q, node["kernel_q"], transpose=True)
        _copy(linear.scale, node["scale"])
    else:
        _copy(linear.weight, node["kernel"], transpose=True)
    if linear.bias is not None:
        _copy(linear.bias, node["bias"])


def _load_norm(norm: torch.nn.Module, node: Mapping) -> None:
    _copy(norm.weight, node["scale"])
    if getattr(norm, "bias", None) is not None:
        _copy(norm.bias, node["bias"])


@torch.no_grad()
def load_jax_params(tree: Mapping, cfg: ModelConfig, device=None,
                    dtype=None) -> Transformer:
    """A :class:`Transformer` for ``cfg`` on ``device`` (None means the
    card) holding the weights of the JAX param tree ``tree``, cast to
    ``dtype`` (default ``cfg.dtype``)."""
    model = Transformer(cfg, device=device, dtype=dtype)
    _copy(model.embed.weight, tree["embed"]["embedding"])
    for i, block in enumerate(model.layers):
        node = tree[f"layers_{i}"]
        _load_norm(block.input_norm, node["input_norm"])
        _load_norm(block.post_attn_norm, node["post_attn_norm"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _load_dense(getattr(block.attn, name), node["attn"][name])
        names = (("gate_proj", "up_proj", "down_proj")
                 if cfg.arch == "llama" else ("up_proj", "down_proj"))
        for name in names:
            _load_dense(getattr(block.mlp, name), node["mlp"][name])
    _load_norm(model.final_norm, tree["final_norm"])
    if model.lm_head is not None:
        _load_dense(model.lm_head, tree["lm_head"])
    return model
