"""KL estimators (port of ``orion_tpu/algos/kl.py``'s ``kl_penalty``).

Given per-token logprobs of the policy (lp) and the frozen reference
(ref_lp):

  k1 = lp - ref_lp                              (unbiased, high variance)
  k2 = (lp - ref_lp)^2 / 2
  k3 = exp(ref_lp - lp) - 1 + (lp - ref_lp)     (unbiased, low variance)
"""

from __future__ import annotations

import torch


def kl_penalty(lp: torch.Tensor, ref_lp: torch.Tensor,
               kind: str = "k1") -> torch.Tensor:
    diff = lp - ref_lp
    if kind == "k1":
        return diff
    if kind == "k2":
        return 0.5 * diff ** 2
    if kind == "k3":
        return torch.exp(-diff) - 1.0 + diff
    raise ValueError(f"unknown KL estimator: {kind}")
