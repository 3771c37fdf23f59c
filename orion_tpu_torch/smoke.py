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
  tokens at temperature 1, 4 minibatches of 8, lr 1e-6, clip 1.0, KL
  0.05, rewarded by the share of even token ids.
"""

from __future__ import annotations

import numpy as np

from orion_tpu_torch.config import (GRPOConfig, ModelConfig,
                                    OptimizerConfig, RolloutConfig)
from orion_tpu_torch.device import torch_dtype
from orion_tpu_torch.models import Transformer
from orion_tpu_torch.rollout.continuous import ContinuousBatchingEngine
from orion_tpu_torch.trainers import GRPOTrainer

EOS = 0  # Pythia's <|endoftext|>


def smoke_engine_and_requests(n_requests: int = 64, seed: int = 0,
                              device="cuda") -> tuple:
    """Build the engine (model weights from seed 0) and the request list
    ``[(req_id, prompt_ids, budget)]`` from ``seed``, and warm the engine
    up (library loads, allocator) on two short requests whose ids lie
    outside the list.  Returns ``(cfg, model, engine, requests)``."""
    cfg = ModelConfig.pythia_1b()
    model = Transformer(cfg, device=device, seed=0)
    rcfg = RolloutConfig(max_prompt_len=512, max_new_tokens=128,
                         temperature=0.0, page_size=64, max_batch_size=32)
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


def smoke_trainer_and_prompts(seed: int = 0, device="cuda") -> tuple:
    """Build the GRPO smoke trainer (policy weights from seed 0) and its
    prompt stream from ``seed``.  Returns ``(cfg, trainer, prompts)``."""
    mc = ModelConfig.pythia_1b()
    cfg = GRPOConfig(
        model=mc,
        rollout=RolloutConfig(engine="continuous", max_batch_size=32,
                              page_size=64, max_prompt_len=256,
                              max_new_tokens=128, temperature=1.0),
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
