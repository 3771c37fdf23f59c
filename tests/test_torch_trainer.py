"""The PyTorch/CUDA port's GRPO trainer (``orion_tpu_torch.trainers``)
against the JAX package's ``GRPOTrainer``: a tiny Pythia-like neox at
f32, the JAX weights carried across with ``load_jax_params``, both
trainers on the continuous engine with page_size 4 and the same
config.  Inputs are made with numpy from fixed seeds and fed to both.
One JAX trainer serves the whole module.

Tolerances (f32 on both sides, sums taken in another order):
- generation at greedy: sequences, masks and lengths identical;
  logprobs within 1e-4 (as the engine tests);
- experience: old/ref logprobs and advantages within 1e-5;
- one update: loss and every stat within 1e-5; gradients within 1e-5
  of the largest gradient entry; parameters after the step within
  lr·1e-3, on the entries whose gradient exceeds 1e-4 — Adam's first
  step is about lr·sign(g), which is ill-conditioned in both
  frameworks where |g| is near eps, so those entries are left out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.config import GRPOConfig as JaxGRPOConfig
from orion_tpu.config import ModelConfig as JaxModelConfig
from orion_tpu.config import OptimizerConfig as JaxOptimizerConfig
from orion_tpu.config import RolloutConfig as JaxRolloutConfig
from orion_tpu.models import Transformer as JaxTransformer
from orion_tpu.models import init_params
from orion_tpu.rollout.engine import GenerationResult as JaxGenerationResult
from orion_tpu.trainers import GRPOTrainer as JaxGRPOTrainer
from orion_tpu.trainers.base import make_schedule as jax_make_schedule
from orion_tpu_torch.config import (GRPOConfig, ModelConfig, OptimizerConfig,
                                    RolloutConfig)
from orion_tpu_torch.models import Transformer
from orion_tpu_torch.models.convert import load_jax_params
from orion_tpu_torch.ops.logprobs import pack_sequences
from orion_tpu_torch.rollout.engine import GenerationResult
from orion_tpu_torch.trainers import GRPOTrainer, make_schedule

NEOX = dict(rotary_pct=0.25, use_parallel_residual=True, attn_bias=True,
            mlp_bias=True, dtype="float32")
ROLLOUT = dict(max_prompt_len=8, max_new_tokens=6, temperature=0.0,
               page_size=4, max_batch_size=8, engine="continuous")
TRAIN = dict(rollout_batch_size=2, group_size=4, minibatch_size=4,
             num_epochs=1, kl_coef=0.05, log_every=0, seed=0)
LR = 1e-2
EOS = 132
LP_ATOL = 1e-4
EXP_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _reward(result, meta):
    comp = np.asarray(result.completions)
    mask = np.asarray(result.completion_mask)
    return ((comp % 2 == 0) * mask).sum(1) / np.maximum(mask.sum(1), 1)


@pytest.fixture(scope="module")
def jax_side():
    """(JAX trainer, its initial weights as numpy, a generation key)."""
    cfg = JaxGRPOConfig(
        model=JaxModelConfig.tiny("neox", **NEOX),
        optimizer=JaxOptimizerConfig(learning_rate=LR, grad_clip=1.0),
        rollout=JaxRolloutConfig(prefix_cache=False, **ROLLOUT), **TRAIN)
    model = JaxTransformer(cfg.model)
    k_init, k_gen = jax.random.split(jax.random.key(0))
    tree = jax.tree.map(np.asarray, init_params(model, k_init, cfg.model))
    # Perturb the zero biases and unit norm scales so every crossing is
    # exercised.
    rng = np.random.RandomState(1)
    tree = jax.tree.map(
        lambda x: (x + 0.05 * rng.randn(*x.shape)).astype(np.float32), tree)
    trainer = JaxGRPOTrainer(cfg, model, jax.tree.map(jnp.asarray, tree),
                             reward_fn=_reward, eos_token_id=EOS)
    yield trainer, tree, k_gen
    trainer.close()


def _port_trainer(tree):
    cfg = GRPOConfig(
        model=ModelConfig.tiny("neox", **NEOX),
        optimizer=OptimizerConfig(learning_rate=LR, grad_clip=1.0),
        rollout=RolloutConfig(**ROLLOUT), **TRAIN)
    model = load_jax_params(tree, cfg.model, device="cpu")
    return GRPOTrainer(cfg, model, reward_fn=_reward, eos_token_id=EOS,
                       device="cpu")


def _port_view(tree, name):
    """The JAX leaf that port parameter ``name`` holds, in the port's
    layout (flax Dense kernels are [in, out], nn.Linear weights
    [out, in])."""
    parts = name.split(".")
    node = tree
    if parts[0] == "embed":
        return np.asarray(tree["embed"]["embedding"])
    if parts[0] == "layers":
        node, parts = tree[f"layers_{parts[1]}"], parts[2:]
    *path, leaf = parts
    for key in path:
        node = node[key]
    if leaf == "bias":
        return np.asarray(node["bias"])
    if "kernel" in node:
        return np.asarray(node["kernel"]).T
    return np.asarray(node["scale"])


def test_generate_batch_greedy_matches_jax(jax_side):
    jtr, tree, k_gen = jax_side
    rng = np.random.RandomState(0)
    lens = np.array([5, 8])
    ids = np.zeros((2, 8), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(1, 256, n)
    batch = {"prompt_ids": ids, "prompt_lens": lens}
    jids, jlens, _ = jtr.prepare_prompts(batch)
    expect = jtr.generate(jids, jlens, rng=k_gen, group_size=4).to_host()
    tr = _port_trainer(tree)
    pids, plens, _ = tr.prepare_prompts(batch)
    got = tr.generate(pids, plens, seed=0)
    for field in ("sequences", "completions", "completion_mask",
                  "completion_lens", "prompt_lens", "total_lens"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(expect, field)),
                                      err_msg=field)
    assert len(set(got.completion_lens.tolist())) > 1  # EOS ended some
    for field in ("logprobs", "policy_logprobs"):
        np.testing.assert_allclose(getattr(got, field),
                                   np.asarray(getattr(expect, field)),
                                   rtol=0, atol=LP_ATOL, err_msg=field)


def _fixed_result(seed, B=8, P=8, T=6, V=256):
    """A numpy GenerationResult's fields: ragged prompts and
    completions (pad 0 after each completion's end)."""
    rng = np.random.RandomState(seed)
    plens = rng.randint(2, P + 1, B).astype(np.int32)
    clens = rng.randint(1, T + 1, B).astype(np.int32)
    prompts = np.zeros((B, P), np.int32)
    comps = np.zeros((B, T), np.int32)
    for b in range(B):
        prompts[b, :plens[b]] = rng.randint(1, V, plens[b])
        comps[b, :clens[b]] = rng.randint(1, V, clens[b])
    mask = (np.arange(T)[None] < clens[:, None]).astype(np.float32)
    seqs = pack_sequences(torch.from_numpy(prompts), torch.from_numpy(plens),
                          torch.from_numpy(comps)).numpy()
    zeros = np.zeros((B, T), np.float32)
    fields = dict(sequences=seqs, completions=comps, completion_mask=mask,
                  completion_lens=clens, logprobs=zeros,
                  policy_logprobs=zeros, prompt_lens=plens,
                  total_lens=plens + clens)
    return fields, rng.rand(B).astype(np.float32)


def test_build_experience_matches_jax(jax_side):
    jtr, tree, _ = jax_side
    fields, scores = _fixed_result(2)
    jexp, jstats = jtr.build_experience(JaxGenerationResult(**fields),
                                        scores)
    exp, stats = _port_trainer(tree).build_experience(
        GenerationResult(**fields), scores)
    assert sorted(exp) == sorted(jexp)
    for key in ("sequences", "prompt_lens", "mask"):
        np.testing.assert_array_equal(exp[key].numpy(),
                                      np.asarray(jexp[key]), err_msg=key)
    for key in ("old_logprobs", "ref_logprobs", "advantages"):
        np.testing.assert_allclose(exp[key].numpy(), np.asarray(jexp[key]),
                                   rtol=0, atol=EXP_ATOL, err_msg=key)
    assert stats == pytest.approx(jstats, abs=1e-6)


def test_one_update_matches_jax(jax_side):
    """One minibatch step on a fixed experience: loss, stats, gradients
    and the parameters after the step.  The old and ref logprobs are
    perturbed so the ratio is clipped somewhere and the KL is live."""
    jtr, tree, _ = jax_side
    fields, scores = _fixed_result(3)
    jexp, _ = jtr.build_experience(JaxGenerationResult(**fields), scores)
    rng = np.random.RandomState(4)
    host = {k: np.array(v) for k, v in jexp.items()}
    mask = host["mask"]
    host["old_logprobs"] = ((host["old_logprobs"]
                             + 0.3 * rng.randn(*mask.shape)) * mask
                            ).astype(np.float32)
    host["ref_logprobs"] = (host["ref_logprobs"]
                            + 0.3 * rng.randn(*mask.shape)).astype(np.float32)
    idx = np.array([5, 0, 3, 6])

    jmb = {k: jnp.asarray(v[idx]) for k, v in host.items()}
    (_, _), jgrads = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True))(
        jtr.state.params, jmb)
    jgrads = jax.tree.map(np.asarray, jgrads)
    new_state, jstats = jax.jit(jtr._update_fn)(
        jtr.state, {k: jnp.asarray(v) for k, v in host.items()},
        jnp.asarray(idx))
    new_params = jax.tree.map(np.asarray, new_state.params)

    tr = _port_trainer(tree)
    exp = {k: torch.from_numpy(v) for k, v in host.items()}
    for key in ("sequences", "prompt_lens"):
        exp[key] = exp[key].to(torch.int64)
    tidx = torch.from_numpy(idx)
    loss, _ = tr.loss_fn(tr.model, {k: v[tidx] for k, v in exp.items()})
    names = [n for n, _ in tr.model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, tr.params)))
    stats = tr._update_fn(exp, tidx)

    assert sorted(stats) == sorted(jstats)
    for key, value in jstats.items():
        np.testing.assert_allclose(float(stats[key]), float(value), rtol=0,
                                   atol=EXP_ATOL, err_msg=key)
    assert 0.0 < float(stats["clip_frac"]) < 1.0
    gmax = max(np.abs(_port_view(jgrads, n)).max() for n in names)
    params = dict(tr.model.named_parameters())
    for n in names:
        jg = _port_view(jgrads, n)
        np.testing.assert_allclose(grads[n].numpy(), jg, rtol=0,
                                   atol=EXP_ATOL * gmax, err_msg=n)
        live = np.abs(jg) > 1e-4
        assert live.any(), n
        np.testing.assert_allclose(
            params[n].detach().numpy()[live],
            _port_view(new_params, n)[live], rtol=0, atol=LR * 1e-3,
            err_msg=n)


@pytest.mark.parametrize("schedule,warmup,total", [
    ("constant", 0, 0), ("constant", 3, 0), ("linear", 2, 9),
    ("cosine", 0, 7), ("cosine", 3, 10)])
def test_lr_schedule_matches_optax(schedule, warmup, total):
    """The learning rate at each update count, warmup and decay
    included, against the JAX package's optax schedule (f32 there, so
    rtol 1e-6)."""
    kw = dict(learning_rate=3e-4, schedule=schedule, warmup_steps=warmup,
              total_steps=total)
    port = make_schedule(OptimizerConfig(**kw))
    ref = jax_make_schedule(JaxOptimizerConfig(**kw))
    for count in range(14):
        expect = float(ref(count)) if callable(ref) else ref
        assert port(count) == pytest.approx(expect, rel=1e-6, abs=1e-12), \
            count


def test_grpo_reward_goes_up():
    """The port's mirror of tests/test_trainers.py's GRPO smoke: a tiny
    llama paid for emitting token 7 learns to emit it (seeded, so
    deterministic on the CPU)."""
    vocab, lucky = 32, 7

    def lucky_token_reward(result, meta):
        comp, mask = result.completions, result.completion_mask
        return ((comp == lucky) * mask).sum(1) / np.maximum(mask.sum(1), 1)

    def prompt_stream(n, plen):
        rng = np.random.RandomState(0)
        while True:
            yield {"prompt_ids": rng.randint(1, vocab, (n, plen)),
                   "prompt_lens": np.full(n, plen, np.int64)}

    mc = ModelConfig.tiny(vocab_size=vocab, hidden_size=32,
                          intermediate_size=64, num_layers=2, num_heads=2,
                          num_kv_heads=2, dtype="float32")
    cfg = GRPOConfig(
        model=mc, optimizer=OptimizerConfig(learning_rate=5e-3,
                                            grad_clip=1.0),
        rollout=RolloutConfig(max_prompt_len=8, max_new_tokens=8,
                              temperature=1.0, page_size=4,
                              max_batch_size=16, engine="continuous"),
        rollout_batch_size=4, minibatch_size=8, group_size=4, kl_coef=0.0,
        num_epochs=1, log_every=0, seed=0)
    tr = GRPOTrainer(cfg, Transformer(mc, device="cpu", seed=0),
                     reward_fn=lucky_token_reward, device="cpu")
    hist = tr.train(prompt_stream(cfg.rollout_batch_size, 5),
                    num_iterations=8)
    first, last = hist[0]["reward_mean"], hist[-1]["reward_mean"]
    assert last > first + 0.05, (first, last)
    assert all(np.isfinite(h["loss"]) for h in hist)
