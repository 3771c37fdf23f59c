"""GRPO trainer (port of ``orion_tpu/trainers/grpo.py``): group-relative
advantages, rule-based rewards, no critic.

Per iteration: repeat each prompt ``group_size`` times -> generate ->
host reward -> group-normalized advantages -> clipped-ratio policy
update with an explicit KL(policy || ref) penalty in the loss (k3).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from orion_tpu_torch.algos import (grpo_advantages, kl_penalty,
                                   masked_mean, ppo_policy_loss)
from orion_tpu_torch.config import GRPOConfig
from orion_tpu_torch.trainers.base import BaseTrainer


class GRPOTrainer(BaseTrainer):
    cfg: GRPOConfig

    def build_experience(self, result, scores):
        T = result.completions.shape[1]
        dev = self.device
        sequences = torch.from_numpy(result.sequences).to(dev, torch.int64)
        prompt_lens = torch.from_numpy(result.prompt_lens).to(
            dev, torch.int64)
        mask = torch.from_numpy(result.completion_mask).to(dev)
        # Sync: old logprobs recomputed under the policy, so the clipped
        # ratio is 1 on the first epoch.
        old_lp = self.behavior_logprobs(sequences, prompt_lens, T)
        with torch.no_grad():
            ref_lp, _ = self._logprobs_fn(self.ref_model, sequences,
                                          prompt_lens, T,
                                          with_entropy=False)
        adv = grpo_advantages(
            torch.from_numpy(np.asarray(scores, np.float32)).to(dev),
            self.cfg.group_size,
            normalize_std=(self.cfg.variant == "grpo"))
        experience = {
            "sequences": sequences,
            "prompt_lens": prompt_lens,
            "mask": mask,
            "old_logprobs": old_lp * mask,
            # ref_logprobs stay unmasked: the k3 estimator exponentiates
            # (ref - lp), and a zeroed ref at pad positions would
            # overflow exp() before the mask can zero the product.
            "ref_logprobs": ref_lp,
            "advantages": adv[:, None] * mask,
        }
        stats = {  # host-side: no device fetches
            "reward_mean": float(np.mean(scores)),
            "reward_std": float(np.std(scores)),
            "completion_len_mean": float(np.mean(result.completion_lens)),
        }
        return experience, stats

    def loss_fn(self, model, mb: Dict[str, torch.Tensor]):
        T = mb["mask"].shape[1]
        lp, ent = self._logprobs_fn(model, mb["sequences"],
                                    mb["prompt_lens"], T)
        pg_loss, stats = ppo_policy_loss(
            lp, mb["old_logprobs"], mb["advantages"], mb["mask"],
            self.cfg.clip_ratio)
        kl = kl_penalty(lp, mb["ref_logprobs"], "k3") * mb["mask"]
        kl_mean = masked_mean(kl, mb["mask"])
        loss = pg_loss + self.cfg.kl_coef * kl_mean
        stats = dict(stats)
        stats["kl"] = kl_mean.detach()
        stats["entropy"] = masked_mean(ent, mb["mask"])
        return loss, stats
