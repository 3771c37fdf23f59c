"""Logprob utilities shared by the rollout engine and the trainer (port
of ``orion_tpu/ops/logprobs.py``): the one definition of how logprobs
are computed (always f32) and how completion tokens line up with
logits in the packed layout.

Packed layout: a sequence row is [prompt(0..len-1) | completion(len..
len+clen-1) | pad].  The logits at index i predict token i+1, so the
logprob of completion token j (absolute index len+j) reads from logits
index len+j-1.
"""

from __future__ import annotations

import torch


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """logp[b, t] = log P(tokens[b, t+1] | logits[b, t]).

    logits [B, L, V] (softmax in f32), tokens [B, L] -> [B, L-1] f32."""
    logps = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    return torch.gather(logps, 2,
                        tokens[:, 1:, None].to(torch.int64))[..., 0]


def completion_window_positions(prompt_lens: torch.Tensor,
                                max_new_tokens: int,
                                seq_len: int) -> torch.Tensor:
    """[B, T] logit positions that predict the completion tokens:
    completion token j (absolute index prompt_len+j) is predicted by
    the logits at prompt_len+j-1, clipped into [0, seq_len)."""
    steps = torch.arange(max_new_tokens, device=prompt_lens.device)
    idx = prompt_lens.to(torch.int64)[:, None] + steps[None, :] - 1
    return idx.clamp(0, seq_len - 1)


def completion_logprobs(logits: torch.Tensor, sequences: torch.Tensor,
                        prompt_lens: torch.Tensor,
                        max_new_tokens: int) -> torch.Tensor:
    """Per-completion-token logprobs [B, T] from a full forward over
    packed sequences (the caller masks positions past each completion's
    length)."""
    all_lp = token_logprobs(logits, sequences)        # [B, L-1]
    idx = completion_window_positions(prompt_lens, max_new_tokens,
                                      all_lp.shape[1])
    return torch.gather(all_lp, 1, idx)


def windowed_completion_logprobs(logits_w: torch.Tensor,
                                 sequences: torch.Tensor,
                                 prompt_lens: torch.Tensor,
                                 max_new_tokens: int) -> torch.Tensor:
    """Per-completion-token logprobs [B, T] from logits [B, T, V] taken
    at ``completion_window_positions`` — the same numbers as
    ``completion_logprobs`` on the full logits."""
    logps = torch.log_softmax(logits_w.to(torch.float32), dim=-1)
    steps = torch.arange(max_new_tokens, device=prompt_lens.device)
    tgt = (prompt_lens.to(torch.int64)[:, None] + steps[None, :]).clamp(
        0, sequences.shape[1] - 1)
    targets = torch.gather(sequences.to(torch.int64), 1, tgt)
    return torch.gather(logps, 2, targets[..., None])[..., 0]


def entropy_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per-position entropy in f32: [B, L, V] -> [B, L]."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -(torch.exp(logp) * logp).sum(dim=-1)


def pack_sequences(prompt_ids: torch.Tensor, prompt_lens: torch.Tensor,
                   completions: torch.Tensor) -> torch.Tensor:
    """Right-pack prompts and completions contiguously.

    prompt_ids [B, P] right-padded, completions [B, T] -> sequences
    [B, P+T] in prompt_ids' dtype, row b being
    [prompt(0..len_b-1) | completion(0..T-1) | junk-from-overlap]: the
    completion window is written at offset len_b over the prompt row
    and a zero tail, so what lies past it is the prompt's padding and
    zeros — bit-identical to the JAX version, whose
    ``dynamic_update_slice`` clamps the offset into [0, P]."""
    B, P = prompt_ids.shape
    T = completions.shape[1]
    seq = torch.zeros((B, P + T), dtype=prompt_ids.dtype,
                      device=prompt_ids.device)
    seq[:, :P] = prompt_ids
    start = prompt_lens.to(torch.int64).clamp(0, P)
    idx = start[:, None] + torch.arange(T, device=prompt_ids.device)[None]
    return seq.scatter_(1, idx, completions.to(seq.dtype))
