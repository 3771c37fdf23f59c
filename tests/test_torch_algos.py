"""The PyTorch/CUDA port's logprob utilities and RL algorithm math
(``orion_tpu_torch.ops.logprobs``, ``orion_tpu_torch.algos``) against
their JAX twins, on numpy-made inputs from fixed seeds, at f32 on the
CPU.

Tolerance: atol 1e-6 — the same f32 formulas (log-softmax, means,
exp) evaluated by two libraries, which may sum in another order.
``pack_sequences`` moves integers and must be bit-identical, its
junk-from-overlap tail included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.algos import advantages as jax_adv
from orion_tpu.algos import kl as jax_kl
from orion_tpu.algos import losses as jax_losses
from orion_tpu.ops import logprobs as jax_lp
from orion_tpu_torch.algos import (grpo_advantages, kl_penalty, masked_mean,
                                   masked_whiten, ppo_policy_loss)
from orion_tpu_torch.ops import logprobs as port_lp

ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _close(got, expect):
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect),
                               rtol=0, atol=ATOL)


def _packed(seed, B=4, P=7, T=5, V=19):
    """Right-padded prompts, completions and their packed rows."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, P + 1, B).astype(np.int32)
    lens[0] = P                                     # a full prompt row
    prompts = np.zeros((B, P), np.int32)
    for b, n in enumerate(lens):
        prompts[b, :n] = rng.randint(1, V, n)
    prompts[1, lens[1]:] = 3                        # non-zero padding
    comps = rng.randint(0, V, (B, T)).astype(np.int32)
    return prompts, lens, comps, rng


def test_pack_sequences_bit_identical():
    prompts, lens, comps, _ = _packed(0)
    expect = np.asarray(jax_lp.pack_sequences(
        jnp.asarray(prompts), jnp.asarray(lens), jnp.asarray(comps)))
    got = port_lp.pack_sequences(torch.from_numpy(prompts),
                                 torch.from_numpy(lens),
                                 torch.from_numpy(comps))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), expect)


def test_logprob_functions_match_jax():
    prompts, lens, comps, rng = _packed(1)
    V, T = 19, comps.shape[1]
    seqs = np.array(jax_lp.pack_sequences(
        jnp.asarray(prompts), jnp.asarray(lens), jnp.asarray(comps)))
    B, L = seqs.shape
    logits = (3.0 * rng.randn(B, L, V)).astype(np.float32)
    tl, ts, tlen = (torch.from_numpy(x) for x in (logits, seqs, lens))
    jl, js, jlen = (jnp.asarray(x) for x in (logits, seqs, lens))

    _close(port_lp.token_logprobs(tl, ts), jax_lp.token_logprobs(jl, js))
    full = port_lp.completion_logprobs(tl, ts, tlen, T)
    _close(full, jax_lp.completion_logprobs(jl, js, jlen, T))
    widx = port_lp.completion_window_positions(tlen, T, L)
    np.testing.assert_array_equal(
        widx.numpy(),
        np.asarray(jax_lp.completion_window_positions(jlen, T, L)))
    logits_w = torch.gather(tl, 1, widx[..., None].expand(-1, -1, V))
    windowed = port_lp.windowed_completion_logprobs(logits_w, ts, tlen, T)
    _close(windowed, jax_lp.windowed_completion_logprobs(
        jnp.asarray(logits_w.numpy()), js, jlen, T))
    _close(windowed, full)
    _close(port_lp.entropy_from_logits(tl),
           jax_lp.entropy_from_logits(jl))


def _tokens(seed, B=6, T=9):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, T + 1, B)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    x = rng.randn(B, T).astype(np.float32)
    return rng, x, mask


def test_masked_stats_match_jax():
    _, x, mask = _tokens(2)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    _close(masked_mean(tx, tm), jax_adv.masked_mean(x, mask))
    _close(masked_mean(tx, tm, dim=1), jax_adv.masked_mean(x, mask, axis=1))
    for shift in (True, False):
        _close(masked_whiten(tx, tm, shift_mean=shift),
               jax_adv.masked_whiten(x, mask, shift_mean=shift))


@pytest.mark.parametrize("variant", ["grpo", "dr_grpo"])
def test_grpo_advantages_match_jax(variant):
    rng = np.random.RandomState(3)
    scores = rng.rand(12).astype(np.float32)
    scores[4:8] = 0.5                  # a group with no spread
    normalize = variant == "grpo"
    _close(grpo_advantages(torch.from_numpy(scores), 4,
                           normalize_std=normalize),
           jax_adv.grpo_advantages(jnp.asarray(scores), 4,
                                   normalize_std=normalize))


@pytest.mark.parametrize("kind", ["k1", "k2", "k3"])
def test_kl_penalty_matches_jax(kind):
    rng, lp, _ = _tokens(4)
    ref = (lp + 0.3 * rng.randn(*lp.shape)).astype(np.float32)
    _close(kl_penalty(torch.from_numpy(lp), torch.from_numpy(ref), kind),
           jax_kl.kl_penalty(jnp.asarray(lp), jnp.asarray(ref), kind))


def test_ppo_policy_loss_and_stats_match_jax():
    rng, lp, mask = _tokens(5)
    old = (lp + 0.3 * rng.randn(*lp.shape)).astype(np.float32)
    adv = (rng.randn(lp.shape[0], 1) * mask).astype(np.float32)
    loss, stats = ppo_policy_loss(*(torch.from_numpy(x)
                                    for x in (lp, old, adv, mask)), 0.2)
    jloss, jstats = jax_losses.ppo_policy_loss(
        *(jnp.asarray(x) for x in (lp, old, adv, mask)), 0.2)
    _close(loss.detach(), jloss)
    assert sorted(stats) == sorted(jstats)
    for key, value in jstats.items():
        _close(stats[key], value)
    assert 0.0 < float(stats["clip_frac"]) < 1.0  # both sides of the clip
