"""Configuration dataclasses of the port.

The port's own copy of what it reads from ``orion_tpu.config``:
``ModelConfig`` whole (minus the JAX-only knobs: remat, scan_layers,
sequence sharding, MoE); the ``RolloutConfig`` fields the
continuous-batching engine reads — int8 weights and KV pools and
k-clone group admission included, the rest of its optional machinery
off (no prefix cache, chunked prefill, speculative decoding, host tier
or repetition penalty — each a later slice); ``OptimizerConfig``; and
the ``TrainConfig`` / ``GRPOConfig`` fields the sync GRPO loop reads.
Names and defaults are the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class ModelConfig:
    """Architecture hyperparameters for the decoder-only transformer.

    ``arch="llama"``: RMSNorm, SwiGLU, full rotary, GQA.
    ``arch="neox"``: LayerNorm, parallel attention+MLP residual,
    partial rotary (Pythia).
    """

    arch: str = "llama"  # "llama" | "neox"
    vocab_size: int = 32000
    hidden_size: int = 512
    intermediate_size: int = 1376
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: int = 8  # < num_heads => GQA (llama only)
    head_dim: int = 0  # 0 => hidden_size // num_heads
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0  # neox uses 0.25
    rms_norm_eps: float = 1e-5
    layernorm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    use_parallel_residual: bool = False  # neox style
    attn_bias: bool = False  # neox uses biases everywhere
    mlp_bias: bool = False
    dtype: str = "bfloat16"  # compute dtype
    # Master-weight dtype of a trained policy.  ``Transformer`` stores
    # its weights in ``dtype`` unless told otherwise (the serving copy);
    # the trainer's policy is built at ``param_dtype`` and computes in
    # ``dtype`` all the same (cast at use).
    param_dtype: str = "float32"
    # "auto": the hand flash kernel for Lq > 1 on CUDA, the reference
    # einsum elsewhere; "reference": always the reference; "ring" /
    # "ulysses": sequence parallel over the ring of an enclosing
    # orion_tpu_torch.parallel.sequence_parallel block.
    attention_impl: str = "auto"
    # Dense layers read int8 weights with per-output-channel f32 scales
    # (``QuantLinear``, ops/quant.py).  Set only on the engine's serving
    # model when RolloutConfig.quantize_weights is on; never on a
    # training model.
    quantize_dense: bool = False

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            self.head_dim = self.hidden_size // self.num_heads
        if self.arch == "neox":
            # GPT-NeoX has no GQA.
            self.num_kv_heads = self.num_heads
        if self.attention_impl not in ("auto", "reference", "ring",
                                       "ulysses"):
            raise ValueError(
                f"attention_impl={self.attention_impl!r}: the port has "
                "'auto', 'reference', 'ring' and 'ulysses'")

    @staticmethod
    def llama3_1b() -> "ModelConfig":
        # Llama-3.2-1B shape.
        return ModelConfig(
            arch="llama", vocab_size=128256, hidden_size=2048,
            intermediate_size=8192, num_layers=16, num_heads=32,
            num_kv_heads=8, rope_theta=500000.0,
        )

    @staticmethod
    def pythia_1b() -> "ModelConfig":
        return ModelConfig(
            arch="neox", vocab_size=50304, hidden_size=2048,
            intermediate_size=8192, num_layers=16, num_heads=8,
            rotary_pct=0.25, use_parallel_residual=True,
            attn_bias=True, mlp_bias=True, layernorm_eps=1e-5,
            tie_word_embeddings=False,
        )

    @staticmethod
    def tiny(arch: str = "llama", **kw: Any) -> "ModelConfig":
        """Small config for tests (runs on CPU in <1s)."""
        base = dict(
            arch=arch, vocab_size=256, hidden_size=64,
            intermediate_size=128, num_layers=2, num_heads=4,
            num_kv_heads=2 if arch == "llama" else 4,
        )
        base.update(kw)
        return ModelConfig(**base)


@dataclass
class RolloutConfig:
    """Continuous-batching engine settings (the serving slice's subset
    of ``orion_tpu.config.RolloutConfig``; same names and defaults)."""

    max_prompt_len: int = 512
    max_new_tokens: int = 512
    temperature: float = 1.0
    top_k: int = 0  # 0 => disabled
    top_p: float = 1.0  # 1.0 => disabled
    # EOS (and every stop id) is suppressed until a sequence has
    # generated this many tokens.
    min_new_tokens: int = 0
    # Extra terminator token ids beyond eos_token_id: sampling any of
    # them ends the sequence (the stop token is kept, like EOS).
    stop_token_ids: tuple = ()
    page_size: int = 64
    num_pages: int = 0  # 0 => max_batch_size * pages per sequence
    # Engine slot count (sequences in flight) and decode tokens per
    # segment.
    max_batch_size: int = 32
    segment_len: int = 16
    # "fifo" | "priority" | "deadline" (scheduler admission order).
    admission_policy: str = "fifo"
    # Pages held back from admission as growth headroom for in-flight
    # sequences; -1 = auto: one page per engine slot.
    page_watermark: int = -1
    # "simple" (the dense fixed-batch engine, not ported yet) |
    # "continuous".  The JAX default; the port's trainer needs
    # "continuous".
    engine: str = "simple"
    # int8 serving (ops/quant.py): the engine's Dense weights stored
    # int8 with per-output-channel scales, and/or its paged KV pools
    # int8 with per-(token, head) scales (decode through kernel D').
    # Off by default; the training graph is never quantized.
    quantize_weights: bool = False
    quantize_kv: bool = False
    # Shared-prefix group admission: a k-clone group prefills its prompt
    # once and its clones share the fully-filled prompt pages.  False =
    # k independent solo requests.
    group_prefix_sharing: bool = True

    def effective_min_new(self, eos_id) -> int:
        """min_new_tokens only binds when SOME terminator can fire."""
        return (self.min_new_tokens
                if eos_id is not None or self.stop_token_ids else 0)

    def check_stop_ids(self, vocab_size: int, eos_id=None) -> None:
        """An out-of-vocab stop or EOS id can never be sampled, which
        would silently disable the terminator."""
        bad = [t for t in self.stop_token_ids if t >= vocab_size]
        if bad:
            raise ValueError(
                f"stop_token_ids {bad} out of range for "
                f"vocab_size={vocab_size}: they could never be sampled, "
                "silently disabling the terminator")
        if eos_id is not None and not 0 <= int(eos_id) < vocab_size:
            raise ValueError(
                f"eos_token_id {eos_id} out of range for "
                f"vocab_size={vocab_size}: it could never be sampled, "
                "silently disabling the terminator")

    def __post_init__(self) -> None:
        ids = self.stop_token_ids
        if isinstance(ids, (int, float)):
            ids = (ids,)
        self.stop_token_ids = tuple(int(t) for t in ids)
        if any(t < 0 for t in self.stop_token_ids):
            raise ValueError(
                f"stop_token_ids must be non-negative, got "
                f"{self.stop_token_ids}")
        if not 0 <= self.min_new_tokens <= self.max_new_tokens:
            raise ValueError(
                f"min_new_tokens={self.min_new_tokens} outside "
                f"[0, max_new_tokens={self.max_new_tokens}]")


@dataclass
class OptimizerConfig:
    name: str = "adamw"
    learning_rate: float = 1e-6
    betas: tuple = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    # Adam moment storage dtypes (None => param dtype); low-precision
    # moments (the JAX package's adamw_lp) are not ported yet.
    mu_dtype: Optional[str] = None
    nu_dtype: Optional[str] = None
    warmup_steps: int = 0
    total_steps: int = 0  # 0 => constant lr after warmup
    schedule: str = "constant"  # "constant" | "linear" | "cosine"


@dataclass
class TrainConfig:
    """The trainer settings the sync loop reads (JAX names and
    defaults)."""

    seed: int = 0
    model: ModelConfig = field(default_factory=ModelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    rollout: RolloutConfig = field(default_factory=RolloutConfig)
    total_iterations: int = 100
    # Prompts per iteration (the size of each batch the prompt iterator
    # yields); num_epochs passes of minibatch_size minibatches over the
    # group-expanded batch.
    rollout_batch_size: int = 32
    minibatch_size: int = 8
    num_epochs: int = 1
    kl_coef: float = 0.05
    # Storage dtype of the frozen reference snapshot (None => the
    # policy's dtype).
    ref_param_dtype: Optional[str] = None
    log_every: int = 1
    # Async mode (decoupled rollout and learner) is not ported yet.
    async_mode: bool = False

    def __post_init__(self) -> None:
        if self.async_mode:
            raise NotImplementedError(
                "async_mode is not ported yet (ROADMAP.md, port modules)")


@dataclass
class GRPOConfig(TrainConfig):
    group_size: int = 8  # completions per prompt
    clip_ratio: float = 0.2
    # "grpo" normalizes by the group std, "dr_grpo" skips it.
    variant: str = "grpo"

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.variant not in ("grpo", "dr_grpo"):
            raise ValueError(f"variant={self.variant!r}: 'grpo' or "
                             "'dr_grpo'")
