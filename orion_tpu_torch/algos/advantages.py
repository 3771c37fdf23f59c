"""Masked statistics and group-relative advantages (port of
``orion_tpu/algos/advantages.py``: ``masked_mean``, ``masked_whiten``,
``grpo_advantages``).  Token tensors are [B, T] over completion tokens
with an f32 mask (1.0 = real token).
"""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None
                ) -> torch.Tensor:
    if dim is None:
        return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return (x * mask).sum(dim=dim) / torch.clamp(mask.sum(dim=dim),
                                                 min=1.0)


def masked_whiten(x: torch.Tensor, mask: torch.Tensor,
                  shift_mean: bool = True, eps: float = 1e-8
                  ) -> torch.Tensor:
    mean = masked_mean(x, mask)
    var = masked_mean((x - mean) ** 2, mask)
    whitened = (x - mean) * torch.rsqrt(var + eps)
    if not shift_mean:
        whitened = whitened + mean
    return whitened * mask


def grpo_advantages(scores: torch.Tensor, group_size: int,
                    normalize_std: bool = True,
                    eps: float = 1e-4) -> torch.Tensor:
    """Group-relative advantages: scores [B] with B = n_prompts * k,
    rows grouped k-consecutive per prompt; centred by the group mean
    and, for "grpo" (not "dr_grpo"), divided by the group's population
    std + eps."""
    groups = scores.reshape(-1, group_size)
    centered = groups - groups.mean(dim=1, keepdim=True)
    if normalize_std:
        centered = centered / (groups.std(dim=1, correction=0,
                                          keepdim=True) + eps)
    return centered.reshape(-1)
