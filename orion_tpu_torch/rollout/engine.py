"""The trainer-facing generation result (port of
``orion_tpu/rollout/engine.py``'s ``GenerationResult``).  The dense
fixed-batch ``RolloutEngine`` of that module is not ported yet
(ROADMAP.md); the continuous engine's ``generate_batch`` fills this.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GenerationResult:
    """Everything downstream consumers (scoring, trainers) need, as host
    numpy arrays — the form a reward function reads."""

    sequences: np.ndarray        # [B, P+T] packed prompt+completion
    completions: np.ndarray      # [B, T] completion tokens (pad after EOS)
    completion_mask: np.ndarray  # [B, T] 1.0 for real completion tokens
    completion_lens: np.ndarray  # [B] number of real completion tokens
    logprobs: np.ndarray         # [B, T] f32 sampling-distribution logprobs
    policy_logprobs: np.ndarray  # [B, T] f32 raw (untempered) policy logprobs
    prompt_lens: np.ndarray      # [B]
    total_lens: np.ndarray       # [B] prompt + completion lengths
