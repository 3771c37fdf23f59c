"""The smoke workloads, each defined once for ``chip_smoke.py`` and its
profiler, so the two always run the same work.

- Serving (``chip_smoke.py``'s engine phase, ``python3 -m
  orion_tpu_torch.profile_engine``): Pythia-1B width with random seeded
  bf16 weights, 32 slots, page size 64, greedy; prompts of 64-512
  tokens and budgets of 16-128, drawn from a numpy seed.
- Training (the train phase, ``python3 -m
  orion_tpu_torch.profile_train``): the sync GRPO trainer at Pythia-1B
  width and full depth, f32 master weights from seed 0 with bf16
  compute; 8 prompts of 64-256 tokens x group 4 = 32 rollouts of 128
  tokens at temperature 1 (each prompt prefilled once, its 4 clones
  sharing its prompt pages), 4 minibatches of 8, lr 1e-6, clip 1.0, KL
  0.05, rewarded by the share of even token ids.

- Long context (``chip_smoke.py``'s longctx phase, ``python3 -m
  orion_tpu_torch.profile_longctx``): one training
  step of a Pythia-1B-width model at full depth (f32 master weights
  from seed 0, bf16 compute) on one sequence of 8,192 token ids drawn
  from a numpy seed, each token's target the next id, mean
  cross-entropy; sequence parallel over a ring of 4 shards in zigzag
  layout (chunks of 1,024, 2,048 tokens a shard) with
  ``attention_impl="ring"``, against the same step dense.

``int8=True`` gives each mix's int8 serving twin (the engine phase's
``engine_int8``, the train phase's ``train_int8``, the profilers'
``--int8``): the same mix with ``quantize_weights=True,
quantize_kv=True`` — int8 Dense weights and int8 KV pools (kernel D').
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from orion_tpu_torch.config import (GRPOConfig, ModelConfig,
                                    OptimizerConfig, RolloutConfig)
from orion_tpu_torch.device import torch_dtype
from orion_tpu_torch.models import Transformer
from orion_tpu_torch.parallel import StackedRing, sequence_parallel
from orion_tpu_torch.rollout.continuous import ContinuousBatchingEngine
from orion_tpu_torch.trainers import GRPOTrainer

EOS = 0  # Pythia's <|endoftext|>


def int8_flags(int8: bool) -> dict:
    """The RolloutConfig fields of the int8 serving twin of a mix."""
    return {"quantize_weights": int8, "quantize_kv": int8}


def smoke_engine_and_requests(n_requests: int = 64, seed: int = 0,
                              device="cuda", int8: bool = False) -> tuple:
    """Build the engine (model weights from seed 0; int8 weights and
    pools with ``int8``) and the request list ``[(req_id, prompt_ids,
    budget)]`` from ``seed``, and warm the engine up (library loads,
    allocator) on two short requests whose ids lie outside the list.
    Returns ``(cfg, model, engine, requests)``; ``model`` is the bf16
    model the engine's weights come from."""
    cfg = ModelConfig.pythia_1b()
    model = Transformer(cfg, device=device, seed=0)
    rcfg = RolloutConfig(max_prompt_len=512, max_new_tokens=128,
                         temperature=0.0, page_size=64, max_batch_size=32,
                         **int8_flags(int8))
    eng = ContinuousBatchingEngine(model, cfg, rcfg, eos_token_id=EOS,
                                   device=device)
    rng = np.random.RandomState(seed)
    reqs = [(i, rng.randint(1, cfg.vocab_size, rng.randint(64, 513)),
             int(rng.randint(16, 129))) for i in range(n_requests)]
    eng.generate([(10_000 + i, reqs[i][1][:64], 4)
                  for i in range(min(2, n_requests))])
    eng.ttft.clear()
    return cfg, model, eng, reqs


def even_token_share(result, meta) -> np.ndarray:
    """Host reward: the share of completion tokens with an even id."""
    comp, mask = result.completions, result.completion_mask
    return ((comp % 2 == 0) * mask).sum(1) / np.maximum(mask.sum(1), 1)


def prompt_batches(n: int, vocab: int, max_len: int, seed: int):
    """Endless batches of n numpy-seeded prompts of 64..max_len tokens,
    right-padded to max_len."""
    rng = np.random.RandomState(seed)
    while True:
        lens = rng.randint(64, max_len + 1, n)
        ids = np.zeros((n, max_len), np.int64)
        for i, ln in enumerate(lens):
            ids[i, :ln] = rng.randint(1, vocab, ln)
        yield {"prompt_ids": ids, "prompt_lens": lens}


def smoke_trainer_and_prompts(seed: int = 0, device="cuda",
                              int8: bool = False) -> tuple:
    """Build the GRPO smoke trainer (policy weights from seed 0; an int8
    rollout engine with ``int8``) and its prompt stream from ``seed``.
    Returns ``(cfg, trainer, prompts)``."""
    mc = ModelConfig.pythia_1b()
    cfg = GRPOConfig(
        model=mc,
        rollout=RolloutConfig(engine="continuous", max_batch_size=32,
                              page_size=64, max_prompt_len=256,
                              max_new_tokens=128, temperature=1.0,
                              **int8_flags(int8)),
        optimizer=OptimizerConfig(learning_rate=1e-6, grad_clip=1.0),
        rollout_batch_size=8, group_size=4, minibatch_size=8,
        num_epochs=1, kl_coef=0.05, log_every=0, seed=0)
    policy = Transformer(mc, device=device,
                         dtype=torch_dtype(mc.param_dtype), seed=0)
    trainer = GRPOTrainer(cfg, policy, reward_fn=even_token_share,
                          eos_token_id=EOS, device=device)
    prompts = prompt_batches(cfg.rollout_batch_size, mc.vocab_size,
                             cfg.rollout.max_prompt_len, seed)
    return cfg, trainer, prompts


LONGCTX_LEN = 8192
LONGCTX_RING = 4


def longctx_loss(model, ids: torch.Tensor, targets: torch.Tensor,
                 ring: Optional[StackedRing] = None) -> torch.Tensor:
    """Mean cross-entropy of ``model``'s logits for ids [B, L] at
    positions 0..L-1 against ``targets`` [B, L].  With ``ring``, ids,
    positions and targets are laid out zigzag over the ring and the
    model (``attention_impl="ring"``) runs inside
    ``sequence_parallel(ring)``; the mean over the shards' tokens is the
    mean over the sequence."""
    B, L = ids.shape
    pos = torch.arange(L, device=ids.device)[None].expand(B, L)
    if ring is None:
        logits = model(ids, pos)
    else:
        with sequence_parallel(ring):
            logits = model(ring.shard(ids), ring.shard(pos))
        targets = ring.shard(targets)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def smoke_longctx(seed: int = 0, device="cuda") -> tuple:
    """The long-context mix: ``(cfg, model, dense, ids, targets,
    ring)`` — the ring model (f32 masters from seed 0,
    ``attention_impl="ring"``), its dense twin (the same weights with
    ``attention_impl="auto"``), one sequence of ``LONGCTX_LEN`` ids
    [1, L] from ``seed`` with the next id as each token's target, and
    the ring of ``LONGCTX_RING`` shards."""
    cfg = dataclasses.replace(ModelConfig.pythia_1b(),
                              attention_impl="ring")
    dtype = torch_dtype(cfg.param_dtype)
    model = Transformer(cfg, device=device, dtype=dtype, seed=0)
    dense = Transformer(dataclasses.replace(cfg, attention_impl="auto"),
                        device=device, dtype=dtype)
    dense.load_state_dict(model.state_dict())
    rng = np.random.RandomState(seed)
    seq = torch.from_numpy(rng.randint(1, cfg.vocab_size, LONGCTX_LEN + 1))
    seq = seq.to(model.embed.weight.device)[None]
    return (cfg, model, dense, seq[:, :-1], seq[:, 1:],
            StackedRing(LONGCTX_RING))
