"""The PyTorch/CUDA port's continuous-batching engine against the JAX
package's ``ContinuousBatchingEngine`` (mirrors tests/test_continuous.py):
the same tiny f32 neox weights, greedy, page_size 4, and the serving
slice's engine configuration (no prefix cache, no chunked prefill, no
speculative decoding).  Prompts are made with numpy from fixed seeds.

Greedy tokens must be IDENTICAL, preemption included; behaviour
logprobs agree within 1e-4 (f32 forwards summed in another order).
"""

import jax
import numpy as np
import pytest
import torch

from orion_tpu.config import ModelConfig as JaxModelConfig
from orion_tpu.config import RolloutConfig as JaxRolloutConfig
from orion_tpu.models import Transformer as JaxTransformer
from orion_tpu.models import init_params
from orion_tpu.rollout.continuous import (
    ContinuousBatchingEngine as JaxEngine)
from orion_tpu_torch.config import ModelConfig, RolloutConfig
from orion_tpu_torch.models.convert import load_jax_params
from orion_tpu_torch.rollout.continuous import ContinuousBatchingEngine

LP_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny("neox", dtype="float32")
    model = JaxTransformer(jcfg)
    params = init_params(model, jax.random.key(0), jcfg)
    return jcfg, model, params


def _config(**kw):
    base = dict(max_prompt_len=12, max_new_tokens=10, temperature=0.0,
                page_size=4, max_batch_size=2)
    base.update(kw)
    return base


def _jax_engine(weights, eos=None, **kw):
    jcfg, model, _ = weights
    return JaxEngine(model, jcfg,
                     JaxRolloutConfig(prefix_cache=False, **_config(**kw)),
                     eos_token_id=eos, segment_len=4)


def _port_engine(weights, eos=None, **kw):
    cfg = ModelConfig.tiny("neox", dtype="float32")
    port = load_jax_params(jax.tree.map(np.asarray, weights[2]), cfg,
                           device="cpu")
    return ContinuousBatchingEngine(port, cfg, RolloutConfig(**_config(**kw)),
                                    eos_token_id=eos, segment_len=4,
                                    device="cpu")


def _run_both(weights, reqs, eos=None, **kw):
    jax_eng = _jax_engine(weights, eos=eos, **kw)
    eng = _port_engine(weights, eos=eos, **kw)
    expect = {r.req_id: r for r in jax_eng.generate(
        reqs, jax.random.key(1), weights[2])}
    got = {r.req_id: r for r in eng.generate(reqs, seed=1)}
    assert sorted(got) == sorted(expect) == sorted(r[0] for r in reqs)
    for i, r in expect.items():
        np.testing.assert_array_equal(got[i].tokens, r.tokens,
                                      err_msg=f"req {i}")
        np.testing.assert_allclose(got[i].logprobs, r.logprobs, rtol=0,
                                   atol=LP_ATOL, err_msg=f"req {i}")
        np.testing.assert_allclose(got[i].policy_logprobs,
                                   r.policy_logprobs, rtol=0,
                                   atol=LP_ATOL, err_msg=f"req {i}")
    return jax_eng, eng, got


def test_matches_solo_greedy(weights):
    """7 ragged requests through 2 slots: slot recycling."""
    rng = np.random.RandomState(0)
    reqs = [(i, rng.randint(1, 256, rng.randint(3, 12)).astype(np.int32))
            for i in range(7)]
    _run_both(weights, reqs)


def test_eos_and_recycling(weights):
    rng = np.random.RandomState(3)
    reqs = [(i, rng.randint(1, 256, rng.randint(2, 12)).astype(np.int32))
            for i in range(6)]
    _, eng, got = _run_both(weights, reqs, eos=5, max_new_tokens=12)
    for r in got.values():
        if 5 in r.tokens:
            assert r.tokens[-1] == 5  # trimmed at EOS
    assert eng.sched.available_pages == eng.num_pages
    assert eng.sched.running == 0 and eng.sched.waiting == 0


def test_per_request_budgets_ragged(weights):
    rng = np.random.RandomState(5)
    reqs = [(i, rng.randint(1, 256, 4 + i % 3).astype(np.int32), 2 + 2 * i)
            for i in range(5)]
    _, _, got = _run_both(weights, reqs)
    for r in got.values():
        assert len(r.tokens) == 2 + 2 * r.req_id


def test_preemption_restart_recompute(weights):
    """A pool too small for every admitted request's growth preempts the
    youngest decoding request; greedy restarts reproduce the JAX
    engine's completions, and both engines preempt alike."""
    rng = np.random.RandomState(4)
    reqs = [(i, rng.randint(1, 256, 9).astype(np.int32)) for i in range(4)]
    jax_eng, eng, _ = _run_both(weights, reqs, max_prompt_len=16,
                                max_new_tokens=8, max_batch_size=4,
                                num_pages=12, page_watermark=0)
    assert eng.preemptions > 0
    assert eng.preemptions == jax_eng.preemptions
    assert eng.sched.running == 0 and eng.sched.waiting == 0
    assert eng.sched.available_pages == 12


def test_pool_too_small_raises(weights):
    eng = _port_engine(weights, max_prompt_len=16, max_new_tokens=8,
                       num_pages=2)
    with pytest.raises(RuntimeError, match="too small"):
        eng.generate([(0, np.ones(14, np.int32))])


def test_submit_step_service_surface(weights):
    """Requests trickled in over step() waves complete with the same
    greedy outputs generate() gives."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 256, 5 + i).astype(np.int32)
               for i in range(5)]
    eng = _port_engine(weights)
    base = {r.req_id: r for r in eng.generate(list(enumerate(prompts)))}
    eng.reset_rng(7)
    done = {}
    eng.submit(0, prompts[0])
    nxt, waves = 1, 0
    while len(done) < len(prompts):
        for r in eng.step():
            done[r.req_id] = r
        if nxt < len(prompts):
            eng.submit(nxt, prompts[nxt])
            nxt += 1
        waves += 1
        assert waves < 100
    assert eng.pending == 0
    for i, r in base.items():
        np.testing.assert_array_equal(done[i].tokens, r.tokens)
    with pytest.raises(ValueError, match="longer than"):
        eng.generate([(9, np.ones(13, np.int32))])


def test_forward_counters(weights):
    """``prefill_forwards`` counts prefill waves and ``decode_steps``
    lockstep decode steps: the counts chip_smoke.py holds the kernels'
    launches against."""
    rng = np.random.RandomState(6)
    p = [rng.randint(1, 256, n).astype(np.int32) for n in (6, 9, 3)]
    eng = _port_engine(weights)
    # The prefill samples the first token; 8 more take 2 segments of 4.
    eng.generate([(0, p[0], 9)])
    assert (eng.prefill_forwards, eng.decode_steps) == (1, 8)
    # Both requests take the two slots in one wave.
    eng.generate([(1, p[1], 5), (2, p[2], 5)])
    assert (eng.prefill_forwards, eng.decode_steps) == (2, 12)


def test_min_new_tokens_and_stop_ids_match_jax(weights):
    """EOS and a stop id suppressed until 3 tokens are generated, then
    terminating: same greedy completions as the JAX engine.  The eos
    and stop ids are the first tokens the engine would emit without
    the controls, so the suppression is exercised."""
    rng = np.random.RandomState(8)
    reqs = [(i, rng.randint(1, 256, rng.randint(3, 12)).astype(np.int32))
            for i in range(4)]
    free = {r.req_id: r for r in _port_engine(weights).generate(reqs)}
    eos, stop = int(free[0].tokens[0]), int(free[1].tokens[1])
    _, _, got = _run_both(weights, reqs, eos=eos, min_new_tokens=3,
                          stop_token_ids=(stop,))
    for r in got.values():
        assert len(r.tokens) >= 3
        assert eos not in r.tokens[:3] and stop not in r.tokens[:3]
        assert r.tokens[-1] in (eos, stop) or len(r.tokens) == 10


def test_priority_admission_order(weights):
    """admission_policy='priority': the higher-priority waiting request
    overtakes earlier arrivals, then FIFO within a class."""
    eng = _port_engine(weights, admission_policy="priority",
                       max_batch_size=1, max_new_tokens=4)
    rng = np.random.RandomState(6)
    p = [rng.randint(1, 256, 6).astype(np.int32) for _ in range(3)]
    eng.reset_rng(0)
    eng.submit(0, p[0], priority=0)
    eng.submit(1, p[1], priority=0)
    eng.submit(2, p[2], priority=9)
    order = []
    while len(order) < 3:
        order.extend(r.req_id for r in eng.step())
    assert order == [2, 0, 1]


def test_sampling_stream_is_the_seeded_generator(weights):
    """At temperature > 0 the engine draws from its own seeded
    generator: one seed reproduces its completions exactly, another
    changes them.  With top-k the sampling logprobs are those of the
    truncated distribution: finite, and never below the policy's."""
    rng = np.random.RandomState(9)
    reqs = [(i, rng.randint(1, 256, 6).astype(np.int32)) for i in range(3)]

    def run(seed):
        eng = _port_engine(weights, temperature=1.0, top_k=8)
        return {r.req_id: r for r in eng.generate(reqs, seed=seed)}

    a, b, c = run(3), run(3), run(4)
    assert all((a[i].tokens == b[i].tokens).all() for i in a)
    assert any((a[i].tokens != c[i].tokens).any() for i in a)
    for r in a.values():
        assert np.isfinite(r.logprobs).all()
        assert (r.logprobs >= r.policy_logprobs - 1e-6).all()


def test_load_weights_installs_new_weights(weights):
    """load_weights(state_dict) on a used engine gives the greedy
    completions of a fresh engine built on those weights."""
    rng = np.random.RandomState(10)
    reqs = [(i, rng.randint(1, 256, 7).astype(np.int32)) for i in range(3)]
    cfg = ModelConfig.tiny("neox", dtype="float32")
    other = load_jax_params(jax.tree.map(
        lambda x: np.asarray(x) * 1.5, weights[2]), cfg, device="cpu")
    used = _port_engine(weights)
    before = {r.req_id: r.tokens for r in used.generate(reqs)}
    used.load_weights(other.state_dict())
    after = {r.req_id: r.tokens for r in used.generate(reqs)}
    fresh = ContinuousBatchingEngine(other, cfg, RolloutConfig(**_config()),
                                     segment_len=4, device="cpu")
    expect = {r.req_id: r.tokens for r in fresh.generate(reqs)}
    assert any((before[i] != after[i]).any() for i in before)
    for i in expect:
        np.testing.assert_array_equal(after[i], expect[i])
