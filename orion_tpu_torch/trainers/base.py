"""Trainer base (port of ``orion_tpu/trainers/base.py``, the sync loop):
optimizer and schedule, the reference snapshot, the experience pipeline
and the minibatch update.

Each iteration runs prompts -> generate -> score -> experience ->
minibatch updates -> weight sync -> stats.  Algorithm subclasses
implement ``build_experience`` (experience from a finished generation;
it does not generate) and ``loss_fn`` (the loss of one minibatch under
a given model); the base class owns prompt preparation, generation,
minibatching, the update step and the loop.

Differences from the JAX trainer: the policy is an ``nn.Module`` that
holds its f32 master weights (``model.param_dtype``) and computes in
``model.dtype``; the optimizer is ``torch.optim.AdamW`` behind optax's
clip-by-global-norm; the loop is eager (stats are fetched each
iteration, not deferred to the next).  Checkpointing, the profiler
window, observability spans, the resilience plan, the recompile
sentinel, evaluation and async mode are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import copy
import math
import time
import warnings
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from orion_tpu_torch.config import OptimizerConfig, TrainConfig
from orion_tpu_torch.device import resolve_device, torch_dtype
from orion_tpu_torch.ops.logprobs import (completion_window_positions,
                                          entropy_from_logits,
                                          windowed_completion_logprobs)
from orion_tpu_torch.rollout.continuous import ContinuousBatchingEngine
from orion_tpu_torch.rollout.engine import GenerationResult


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """The learning rate as a function of the update count (0 at the
    first update): optax's linear warmup from 0, then constant, linear
    decay to 0 or cosine decay to 0 over ``total_steps - warmup_steps``
    updates (the JAX package's ``make_schedule``)."""
    base = cfg.learning_rate
    if cfg.schedule not in ("constant", "linear", "cosine"):
        raise ValueError(f"schedule={cfg.schedule!r}: 'constant', "
                         "'linear' or 'cosine'")
    if cfg.schedule != "constant" and cfg.total_steps <= 0:
        raise ValueError(
            f"schedule={cfg.schedule!r} needs optimizer.total_steps > 0 "
            "(the decay horizon); total_steps=0 only works with 'constant'")
    warm = max(cfg.warmup_steps, 1)
    rest = max(cfg.total_steps - cfg.warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < cfg.warmup_steps:
            return base * count / warm
        n = min(count - cfg.warmup_steps, rest)
        if cfg.schedule == "cosine":
            return base * 0.5 * (1.0 + math.cos(math.pi * n / rest))
        if cfg.schedule == "linear":
            return base * (1.0 - n / rest)
        return base

    return schedule


def make_optimizer(cfg: OptimizerConfig, params) -> torch.optim.AdamW:
    """AdamW over ``params`` (the learning rate is set from the schedule
    before each step).  Gradient clipping is :func:`clip_by_global_norm`,
    applied by the trainer before the step, as optax chains it."""
    if cfg.name != "adamw":
        raise ValueError(f"optimizer {cfg.name!r}: the port has 'adamw'")
    if cfg.mu_dtype is not None or cfg.nu_dtype is not None:
        raise NotImplementedError(
            "low-precision Adam moments (mu_dtype/nu_dtype, the JAX "
            "package's adamw_lp) are not ported yet (ROADMAP.md)")
    return torch.optim.AdamW(params, lr=cfg.learning_rate,
                             betas=tuple(cfg.betas), eps=cfg.eps,
                             weight_decay=cfg.weight_decay)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all entries, in f32 (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.to(torch.float32)) for t in tensors]))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float
                        ) -> torch.Tensor:
    """Scale ``grads`` in place by min(1, max_norm / ||g||), as
    ``optax.clip_by_global_norm`` does (``clip_grad_norm_`` would add
    1e-6 to the norm).  Returns the norm before clipping.  No host
    sync."""
    norm = global_norm(grads)
    torch._foreach_mul_(grads, torch.clamp(max_norm / norm, max=1.0))
    return norm


class BaseTrainer:
    """The sync training loop; see :class:`GRPOTrainer`.

    Args:
      cfg: algorithm config (a TrainConfig subclass);
        ``cfg.rollout.engine`` must be ``"continuous"``.
      model: the policy :class:`~orion_tpu_torch.models.Transformer`,
        its weights stored in ``cfg.model.param_dtype``; it is trained
        in place.  The frozen reference is a snapshot of it at
        construction, stored in ``cfg.ref_param_dtype`` (None: the
        policy's dtype); the engine samples from its own copy in
        ``cfg.model.dtype``, refreshed by :meth:`sync_weights`.
      reward_fn: host callable (GenerationResult, meta) -> [B] scores.
      eos/pad token ids: generation termination.
      device: None means the card (raises without one); ``"cpu"`` for
        the tests.
    """

    def __init__(self, cfg: TrainConfig, model,
                 reward_fn: Optional[Callable] = None,
                 eos_token_id: Optional[int] = None, pad_token_id: int = 0,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.rollout.engine == "simple":
            raise NotImplementedError(
                "rollout.engine='simple' (the dense fixed-batch "
                "RolloutEngine) is not ported yet (ROADMAP.md, port "
                "modules); set rollout.engine='continuous'")
        if cfg.rollout.engine != "continuous":
            raise ValueError(f"rollout.engine must be 'simple' or "
                             f"'continuous', got {cfg.rollout.engine!r}")
        pdt = torch_dtype(cfg.model.param_dtype)
        bad = {p.dtype for p in model.parameters()} - {pdt}
        if bad:
            raise ValueError(
                f"the policy's weights are {sorted(map(str, bad))}; build "
                f"it with dtype=model.param_dtype ({cfg.model.param_dtype})")
        self.model = model.to(self.device)
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = make_optimizer(cfg.optimizer, self.params)
        self.schedule = make_schedule(cfg.optimizer)
        self.step = 0
        self.reward_fn = reward_fn
        self.ref_model = self._frozen_copy(cfg.ref_param_dtype)
        # The engine's own compute-dtype copy (the JAX engine installs
        # one at load_weights), so sampling never reads f32 masters.
        self.engine = ContinuousBatchingEngine(
            self._frozen_copy(cfg.model.dtype), cfg.model, cfg.rollout,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id,
            device=self.device)
        self.metrics_history: list = []
        self.global_iter = 0
        # Minibatch permutations draw from the same stream as the JAX
        # trainer's; sampling seeds come from a second one.
        self._np_rng = np.random.RandomState(cfg.seed)
        self._seed_rng = np.random.RandomState([cfg.seed, 1])

    def _frozen_copy(self, dtype: Optional[str]) -> torch.nn.Module:
        model = copy.deepcopy(self.model).requires_grad_(False)
        return model if dtype is None else model.to(torch_dtype(dtype))

    # ------------------------------------------------------------------
    # forward helpers
    # ------------------------------------------------------------------
    def _logprobs_fn(self, model, sequences: torch.Tensor,
                     prompt_lens: torch.Tensor, max_new: int,
                     with_entropy: bool = True):
        """Completion logprobs (+ entropy) of ``model``: a forward whose
        vocab projection runs only at the T positions that predict
        completion tokens (the JAX trainer's ``_windowed_forward``).
        Returns (logprobs [B, T] f32, entropy [B, T] f32 or None); the
        entropy carries no gradient."""
        B, L = sequences.shape
        positions = torch.arange(L, device=sequences.device).expand(B, L)
        widx = completion_window_positions(prompt_lens, max_new, L)
        logits_w = model(sequences, positions, logits_positions=widx)
        lp = windowed_completion_logprobs(logits_w, sequences, prompt_lens,
                                          max_new)
        ent = (entropy_from_logits(logits_w.detach()) if with_entropy
               else None)
        return lp, ent

    def loss_fn(self, model, mb: Dict[str, torch.Tensor]):
        """(loss, stats) of one minibatch under ``model``."""
        raise NotImplementedError

    def _update_fn(self, experience: Dict[str, torch.Tensor],
                   idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One optimizer step on the minibatch ``experience[idx]``;
        returns its stats as device scalars, ``grad_norm`` taken before
        clipping (``optax.global_norm(grads)``)."""
        mb = {k: v[idx] for k, v in experience.items()}
        self.optimizer.zero_grad(set_to_none=True)
        loss, stats = self.loss_fn(self.model, mb)
        loss.backward()
        for p in self.params:
            if p.grad is None:   # optax sees a zero gradient
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.cfg.optimizer.grad_clip > 0:
            grad_norm = clip_by_global_norm(grads,
                                            self.cfg.optimizer.grad_clip)
        else:
            grad_norm = global_norm(grads)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1
        stats = dict(stats)
        stats["grad_norm"] = grad_norm
        stats["loss"] = loss.detach()
        return stats

    # ------------------------------------------------------------------
    # experience pipeline
    # ------------------------------------------------------------------
    def next_seed(self) -> int:
        return int(self._seed_rng.randint(2 ** 31 - 1))

    def generate(self, prompt_ids, prompt_lens,
                 seed: Optional[int] = None) -> GenerationResult:
        """Sample completions for a (group-repeated) prompt batch.  The
        engine's ``supports_groups`` is False until k-clone group
        admission is ported, so it takes the repeated batch as it is;
        row i*k+j is clone j of prompt i either way."""
        seed = self.next_seed() if seed is None else seed
        return self.engine.generate_batch(prompt_ids, prompt_lens, seed)

    def score(self, result: GenerationResult, meta: dict) -> np.ndarray:
        """Sequence-level scores [B] as host f32; non-finite scores are
        reported, since the sync path feeds them to the update."""
        if self.reward_fn is None:
            raise ValueError("no reward_fn configured")
        scores = np.asarray(self.reward_fn(result, meta),
                            np.float32).reshape(-1)
        n_bad = int((~np.isfinite(scores)).sum())
        if n_bad:
            warnings.warn(
                f"reward_fn emitted {n_bad}/{scores.size} non-finite "
                "scores — the sync path feeds them to the update step",
                stacklevel=2)
        return scores

    def prepare_prompts(self, batch: dict):
        """(prompt_ids, prompt_lens, meta) — group trainers repeat each
        prompt ``cfg.group_size`` times (row i*k+j)."""
        k = getattr(self.cfg, "group_size", 1)
        ids = np.asarray(batch["prompt_ids"])
        lens = np.asarray(batch["prompt_lens"])
        meta = {key: np.asarray(v) for key, v in batch.items()
                if key not in ("prompt_ids", "prompt_lens")}
        if k > 1:
            ids = np.repeat(ids, k, axis=0)
            lens = np.repeat(lens, k, axis=0)
            meta = {key: np.repeat(v, k, axis=0) for key, v in meta.items()}
        return ids, lens, meta

    @torch.no_grad()
    def behavior_logprobs(self, sequences: torch.Tensor,
                          prompt_lens: torch.Tensor,
                          max_new: int) -> torch.Tensor:
        """old_logprobs for the importance ratio.  Sync mode recomputes
        them under the current policy, so the ratio is 1 at the first
        minibatch up to the forward's rounding (async mode, which would
        take the engine's sampling-distribution logprobs, is not
        ported)."""
        lp, _ = self._logprobs_fn(self.model, sequences, prompt_lens,
                                  max_new, with_entropy=False)
        return lp

    def build_experience(self, result: GenerationResult, scores):
        """(experience dict of device tensors, host stats dict)."""
        raise NotImplementedError

    def make_experience(self, batch: dict):
        """prompts -> generate -> score -> experience."""
        ids, lens, meta = self.prepare_prompts(batch)
        result = self.generate(ids, lens)
        return self.build_experience(result, self.score(result, meta))

    def update_epochs(self, experience: Dict[str, torch.Tensor]) -> dict:
        """num_epochs passes of minibatches, each a slice of one numpy
        permutation per epoch; returns each stat's mean over the
        minibatches (one device->host fetch)."""
        B = int(experience["prompt_lens"].shape[0])
        mb = self.cfg.minibatch_size
        if B % mb:
            raise ValueError(f"batch {B} not divisible by minibatch {mb}")
        perms = np.stack([self._np_rng.permutation(B)
                          for _ in range(self.cfg.num_epochs)])
        idx_mat = torch.from_numpy(perms.reshape(-1, mb)).to(self.device)
        rows = [self._update_fn(experience, idx) for idx in idx_mat]
        keys = list(rows[0])
        host = torch.stack([torch.stack([r[k].to(torch.float32)
                                         for k in keys])
                            for r in rows]).cpu().numpy()
        return {k: float(np.mean(host[:, i])) for i, k in enumerate(keys)}

    def sync_weights(self) -> None:
        """Trainer -> rollout weight sync: the engine's copy takes the
        policy's weights, cast to its dtype."""
        self.engine.load_weights(self.model.state_dict())

    def _wait(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, prompt_iter: Iterator[dict],
              num_iterations: Optional[int] = None) -> list:
        """The outer loop.  ``num_iterations`` means "run this many
        more"; without it the horizon is ``cfg.total_iterations`` in
        all, counted by ``global_iter``.  Returns the per-iteration
        stats (``metrics_history``)."""
        n = (num_iterations if num_iterations is not None
             else max(0, self.cfg.total_iterations - self.global_iter))
        for it in range(n):
            t0 = time.perf_counter()
            batch = next(prompt_iter)
            experience, exp_stats = self.make_experience(batch)
            self._wait()
            t1 = time.perf_counter()
            upd = self.update_epochs(experience)
            self.sync_weights()
            self._wait()
            t2 = time.perf_counter()
            self.global_iter += 1
            n_samples = int(experience["prompt_lens"].shape[0])
            stats = {**upd, **exp_stats, "iteration": it,
                     "time_rollout_s": t1 - t0, "time_update_s": t2 - t1,
                     "samples_per_sec": n_samples / max(t2 - t0, 1e-9)}
            self.metrics_history.append(stats)
            if self.cfg.log_every and it % self.cfg.log_every == 0:
                self.log(stats)
        return self.metrics_history

    def log(self, stats: dict) -> None:
        keys = ("iteration", "reward_mean", "loss", "kl", "samples_per_sec")
        msg = " ".join(f"{k}={stats[k]:.4g}" for k in keys if k in stats)
        print(f"[orion-tpu-torch] {msg}", flush=True)
