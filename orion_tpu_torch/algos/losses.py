"""The clipped policy loss (port of ``orion_tpu/algos/losses.py``'s
``ppo_policy_loss``), over [B, T] token tensors, in f32."""

from __future__ import annotations

import torch

from orion_tpu_torch.algos.advantages import masked_mean


def ppo_policy_loss(logprobs: torch.Tensor, old_logprobs: torch.Tensor,
                    advantages: torch.Tensor, mask: torch.Tensor,
                    clip_ratio: float) -> tuple:
    """Clipped surrogate objective over completion tokens; returns
    (loss, stats) with stats ``policy_loss``, ``clip_frac``,
    ``approx_kl`` and ``ratio_mean`` (detached)."""
    logratio = (logprobs - old_logprobs) * mask
    ratio = torch.exp(logratio)
    unclipped = -advantages * ratio
    clipped = -advantages * torch.clamp(ratio, 1.0 - clip_ratio,
                                        1.0 + clip_ratio)
    loss = masked_mean(torch.maximum(unclipped, clipped), mask)
    with torch.no_grad():
        stats = {
            "policy_loss": loss.detach(),
            "clip_frac": masked_mean(
                ((ratio - 1.0).abs() > clip_ratio).to(torch.float32), mask),
            "approx_kl": masked_mean(0.5 * logratio ** 2, mask),
            "ratio_mean": masked_mean(ratio, mask),
        }
    return loss, stats
