"""int8 quantization for the serving path (port of
``orion_tpu/ops/quant.py``).

- **Weight-only int8** (``quantize_params_int8`` + the transformer's
  ``QuantLinear``): every Dense weight is stored int8 with a
  per-output-channel f32 scale, and the product computes
  ``(x @ weight_q.to(dt).T) * scale``.
- **int8 KV pools** (``quantize_kv`` / ``dequant_kv``): K and V stored
  int8 with one f32 scale per (token, head) over the head dim; decode
  applies the scales inside kernel D', prefill dequantizes on the
  gather.

The arithmetic is the reference's: f32, ``scale = max(amax, 1e-8) /
127``, a true division by the scale, round half to even, clip to ±127.
The port's ``Linear`` weight is [out, in] where flax's kernel is
[in, out], so the per-output-channel amax runs over dim 1 here.
"""

from __future__ import annotations

from typing import Dict

import torch

_EPS = 1e-8


def quantize_kernel(weight: torch.Tensor):
    """[out, in] float weight -> (int8 weight [out, in], f32 scale
    [out], one per output channel)."""
    w32 = weight.to(torch.float32)
    scale = torch.clamp(w32.abs().amax(dim=1), min=_EPS) / 127.0
    q = torch.clamp(torch.round(w32 / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_params_int8(state_dict: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Map every Dense weight ``<name>.weight`` of a port state dict to
    the ``QuantLinear`` layout ``<name>.weight_q`` (int8) and
    ``<name>.scale`` (f32); biases, norms and the embedding table
    (``embed.weight``, the one 2-D weight that is not a Dense one) pass
    through.  The result loads into a model built with
    ``ModelConfig.quantize_dense=True``; an already-quantized dict
    passes through unchanged."""
    out = {}
    for name, t in state_dict.items():
        if (name.endswith(".weight") and name != "embed.weight"
                and t.dim() == 2 and t.is_floating_point()):
            q, scale = quantize_kernel(t)
            prefix = name[:-len("weight")]
            out[prefix + "weight_q"] = q
            out[prefix + "scale"] = scale
        else:
            out[name] = t
    return out


def quantize_kv(x: torch.Tensor):
    """[..., D] K or V -> (int8 values [..., D], f32 scale [...]), one
    symmetric scale per vector (per token per head)."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.abs().amax(dim=-1), min=_EPS) / 127.0
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequant_kv(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (the prefill gather's path)."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)
