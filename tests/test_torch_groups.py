"""k-clone group admission in the PyTorch/CUDA port's continuous engine
(``orion_tpu_torch``), against the JAX package's group engine and the
port's own solo requests (mirrors tests/test_group_sampling.py), plus
the trainer's group dispatch against the JAX ``GRPOTrainer``.  Tiny f32
models, page size 4, prompts made with numpy from fixed seeds; one JAX
trainer serves the module.

A group prefills its prompt once; its clones share the fully-filled
prompt pages and each other clone decodes on a private copy of the
partial last prompt page (scale pages included with int8 pools).

Tolerances: greedy tokens identical; logprobs atol 1e-4 against the
JAX engine (f32 forwards summed in another order), rtol 1e-5 against
the port's own solo requests (the same forwards in another batch).
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
from orion_tpu.rollout.continuous import (
    ContinuousBatchingEngine as JaxEngine)
from orion_tpu.trainers import GRPOTrainer as JaxGRPOTrainer
from orion_tpu_torch.config import (GRPOConfig, ModelConfig, OptimizerConfig,
                                    RolloutConfig)
from orion_tpu_torch.models.convert import load_jax_params
from orion_tpu_torch.rollout.continuous import ContinuousBatchingEngine
from orion_tpu_torch.trainers import GRPOTrainer
from orion_tpu_torch.trainers.base import (BaseTrainer,
                                           dispatch_generate_batch)

LP_ATOL = 1e-4
SOLO_RTOL = 1e-5
ENGINE = dict(max_prompt_len=12, max_new_tokens=8, temperature=0.0,
              page_size=4, max_batch_size=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxModelConfig.tiny(dtype="float32")
    model = JaxTransformer(jcfg)
    params = init_params(model, jax.random.key(0), jcfg)
    return jcfg, model, params


def _port(weights, **kw):
    cfg = ModelConfig.tiny(dtype="float32")
    model = load_jax_params(jax.tree.map(np.asarray, weights[2]), cfg,
                            device="cpu")
    return ContinuousBatchingEngine(model, cfg,
                                    RolloutConfig(**{**ENGINE, **kw}),
                                    segment_len=4, device="cpu")


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, n).astype(np.int32) for n in lens]


def _assert_same(got, expect, atol=None, rtol=None):
    assert sorted(got) == sorted(expect)
    for rid, r in expect.items():
        np.testing.assert_array_equal(got[rid].tokens, r.tokens,
                                      err_msg=f"req {rid}")
        np.testing.assert_allclose(got[rid].logprobs, r.logprobs,
                                   rtol=rtol or 0, atol=atol or 0,
                                   err_msg=f"req {rid}")


def test_group_greedy_matches_jax_and_solo(weights):
    """Prompts of 3, 7 and 11 tokens (partial last pages of 3 and 3
    tokens, one of 3 inside a single page), 4 clones each: the same
    greedy completions as the JAX group engine and as the port's own
    k solo requests.  8 slots take two groups in the first wave and the
    third in a second: two prefill forwards for 12 completions."""
    jcfg, jmodel, params = weights
    prompts = _prompts(0, (3, 7, 11))
    k = 4
    groups = [(i * k, p, None, k) for i, p in enumerate(prompts)]
    jax_eng = JaxEngine(jmodel, jcfg, JaxRolloutConfig(prefix_cache=False,
                                                       **ENGINE),
                        segment_len=4)
    expect = {r.req_id: r for r in jax_eng.generate(
        groups, jax.random.key(1), params)}
    eng = _port(weights)
    got = {r.req_id: r for r in eng.generate(groups, seed=1)}
    _assert_same(got, expect, atol=LP_ATOL)
    assert eng.prefill_forwards == 2
    solo = {r.req_id: r for r in _port(weights).generate(
        [(i * k + j, p) for i, p in enumerate(prompts) for j in range(k)])}
    _assert_same(got, solo, rtol=SOLO_RTOL)
    assert eng.sched.available_pages == eng.num_pages


def test_group_page_accounting(weights):
    """A k-clone group reserves shared + k private pages at admission:
    prompt of 8 at page size 4 -> 2 shared pages + 1 private page per
    clone; every clone's table starts with the same two pages, and the
    pages free only when the last clone finishes."""
    eng = _port(weights, num_pages=64)
    k = 8
    eng.sched.add_group(0, 8, 8, k)
    admitted = eng.sched.admit()
    assert len(admitted) == k
    assert 64 - eng.sched.free_pages == 2 + k
    tables = [eng.sched.pages(rid) for rid, _ in admitted]
    for t in tables[1:]:
        assert t[:2] == tables[0][:2] and t[2:] != tables[0][2:]
    for rid, _ in admitted[:-1]:
        eng.sched.finish(rid)
    assert 64 - eng.sched.free_pages == 2 + 1
    eng.sched.finish(admitted[-1][0])
    assert eng.sched.free_pages == 64


def test_group_stochastic_clones_differ(weights):
    eng = _port(weights, temperature=1.0)
    out = eng.generate([(0, _prompts(1, (6,))[0], None, 6)], seed=3)
    assert len(out) == 6
    assert len({tuple(r.tokens.tolist()) for r in out}) >= 2


def test_generate_batch_group_layout(weights):
    """generate_batch(group_size=k) returns rows in the repeated i*k+j
    layout and, with group_prefix_sharing=False (k solo requests), the
    same greedy rows."""
    B, k = 3, 4
    lens = np.asarray([5, 9, 12], np.int32)
    ids = np.zeros((B, 12), np.int32)
    for i, p in enumerate(_prompts(2, lens)):
        ids[i, :lens[i]] = p
    shared = _port(weights).generate_batch(ids, lens, 5, group_size=k)
    solo = _port(weights, group_prefix_sharing=False).generate_batch(
        ids, lens, 5, group_size=k)
    assert shared.completions.shape == (B * k, ENGINE["max_new_tokens"])
    np.testing.assert_array_equal(shared.prompt_lens, np.repeat(lens, k))
    for i in range(B):
        np.testing.assert_array_equal(shared.sequences[i * k, :lens[i]],
                                      ids[i, :lens[i]])
    for field in ("sequences", "completions", "completion_lens"):
        np.testing.assert_array_equal(getattr(shared, field),
                                      getattr(solo, field), err_msg=field)
    for i in range(B):
        block = shared.completions[i * k:(i + 1) * k]
        np.testing.assert_array_equal(block, np.broadcast_to(block[0],
                                                             block.shape))


def test_int8_groups_match_int8_solo(weights):
    """int8 pools and weights with groups: greedy-identical to the same
    prompts as int8 solo requests — each clone decodes on its copy of
    the partial last prompt page, scale pages included."""
    prompts = _prompts(3, (5, 7, 10))
    k = 3
    flags = dict(quantize_weights=True, quantize_kv=True)
    eng = _port(weights, **flags)
    got = {r.req_id: r for r in eng.generate(
        [(i * k, p, None, k) for i, p in enumerate(prompts)])}
    solo = {r.req_id: r for r in _port(weights, **flags).generate(
        [(i * k + j, p) for i, p in enumerate(prompts) for j in range(k)])}
    _assert_same(got, solo, rtol=SOLO_RTOL)


def test_groups_queue_and_preempted_clones_restart_solo(weights):
    """5 groups of 2 on 4 slots queue and admit atomically; a pool too
    small for every clone's growth preempts clones, which restart as
    solo requests.  Greedy completions still equal a solo run's, and
    every page is returned."""
    prompts = _prompts(4, (3, 4, 5, 6, 7))
    k = 2
    eng = _port(weights, max_batch_size=4, num_pages=10, page_watermark=0)
    out = {r.req_id: r for r in eng.generate(
        [(i * k, p, None, k) for i, p in enumerate(prompts)])}
    assert eng.preemptions > 0
    solo = _port(weights)
    for i, p in enumerate(prompts):
        ref = solo.generate([(0, p)])[0]
        for j in range(k):
            np.testing.assert_array_equal(out[i * k + j].tokens, ref.tokens,
                                          err_msg=f"group {i} clone {j}")
    assert eng.sched.available_pages == eng.num_pages
    assert eng.sched.running == 0 and eng.sched.waiting == 0


def test_group_validation_leaves_engine_usable(weights):
    eng = _port(weights, max_batch_size=4)
    good = np.ones(4, np.int32)
    with pytest.raises(ValueError, match="never be admitted"):
        eng.generate([(0, good), (1, good, None, 5)])
    with pytest.raises(ValueError, match="already in flight"):
        eng.generate([(0, good, None, 2), (1, good)])
    assert eng.sched.waiting == 0 and eng.sched.running == 0
    out = eng.generate([(0, good), (1, good, None, 2)])
    assert sorted(r.req_id for r in out) == [0, 1, 2]


def test_dispatch_dedups_repeated_layout():
    """The trainer's dispatch hands a group-capable engine the unique
    prompts + group_size, anything else the repeated batch, and refuses
    a batch that is not in the i*k+j layout."""
    calls = {}

    class Engine:
        supports_groups = True

        def generate_batch(self, ids, lens, seed, group_size=1):
            calls.update(ids=np.asarray(ids), k=group_size)
            return "ok"

    uids = np.arange(12, dtype=np.int32).reshape(3, 4)
    ulens = np.asarray([4, 3, 2], np.int32)
    rep_ids, rep_lens = np.repeat(uids, 2, axis=0), np.repeat(ulens, 2)
    assert dispatch_generate_batch(Engine(), rep_ids, rep_lens, 0,
                                   group_size=2) == "ok"
    np.testing.assert_array_equal(calls["ids"], uids)
    assert calls["k"] == 2
    Engine.supports_groups = False
    dispatch_generate_batch(Engine(), rep_ids, rep_lens, 0, group_size=2)
    np.testing.assert_array_equal(calls["ids"], rep_ids)
    assert calls["k"] == 1
    Engine.supports_groups = True
    with pytest.raises(ValueError, match="repeated"):
        dispatch_generate_batch(Engine(), np.concatenate([uids, uids]),
                                np.concatenate([ulens, ulens]), 0,
                                group_size=2)
    trainer = BaseTrainer.__new__(BaseTrainer)
    trainer.engine = Engine()
    assert trainer.generate(rep_ids, rep_lens, seed=0, group_size=2) == "ok"
    np.testing.assert_array_equal(calls["ids"], uids)


# -- the trainer: group dispatch with the int8 rollout ------------------------

NEOX = dict(rotary_pct=0.25, use_parallel_residual=True, attn_bias=True,
            mlp_bias=True, dtype="float32")
ROLLOUT = dict(max_prompt_len=8, max_new_tokens=6, temperature=0.0,
               page_size=4, max_batch_size=8, engine="continuous",
               quantize_weights=True, quantize_kv=True)
TRAIN = dict(rollout_batch_size=2, group_size=4, minibatch_size=4,
             num_epochs=1, kl_coef=0.05, log_every=0, seed=0)
EOS = 132


def _reward(result, meta):
    comp = np.asarray(result.completions)
    mask = np.asarray(result.completion_mask)
    return ((comp % 2 == 0) * mask).sum(1) / np.maximum(mask.sum(1), 1)


def test_grpo_int8_group_rollout_matches_jax():
    """The GRPO trainer's generate goes through the group dispatch (one
    prefill for the 2 prompts x 4 clones) over the int8 engine, and its
    greedy rows equal the JAX GRPOTrainer's with the same rollout flags;
    the sync re-quantizes the policy's weights into the engine."""
    jcfg = JaxGRPOConfig(
        model=JaxModelConfig.tiny("neox", **NEOX),
        optimizer=JaxOptimizerConfig(learning_rate=1e-2),
        rollout=JaxRolloutConfig(prefix_cache=False, **ROLLOUT), **TRAIN)
    jmodel = JaxTransformer(jcfg.model)
    k_init, k_gen = jax.random.split(jax.random.key(0))
    tree = jax.tree.map(np.asarray, init_params(jmodel, k_init, jcfg.model))
    jtr = JaxGRPOTrainer(jcfg, jmodel, jax.tree.map(jnp.asarray, tree),
                         reward_fn=_reward, eos_token_id=EOS)
    rng = np.random.RandomState(0)
    lens = np.array([5, 8])
    ids = np.zeros((2, 8), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(1, 256, n)
    batch = {"prompt_ids": ids, "prompt_lens": lens}
    try:
        jids, jlens, _ = jtr.prepare_prompts(batch)
        expect = jtr.generate(jids, jlens, rng=k_gen,
                              group_size=4).to_host()
    finally:
        jtr.close()
    cfg = GRPOConfig(model=ModelConfig.tiny("neox", **NEOX),
                     optimizer=OptimizerConfig(learning_rate=1e-2),
                     rollout=RolloutConfig(**ROLLOUT), **TRAIN)
    tr = GRPOTrainer(cfg, load_jax_params(tree, cfg.model, device="cpu"),
                     reward_fn=_reward, eos_token_id=EOS, device="cpu")
    pids, plens, _ = tr.prepare_prompts(batch)
    got = tr.generate(pids, plens, seed=0, group_size=4)
    assert tr.engine.prefill_forwards == 1
    for field in ("sequences", "completions", "completion_mask",
                  "completion_lens"):
        np.testing.assert_array_equal(getattr(got, field),
                                      np.asarray(getattr(expect, field)),
                                      err_msg=field)
    np.testing.assert_allclose(got.logprobs, np.asarray(expect.logprobs),
                               rtol=0, atol=LP_ATOL)
    # One update, then the sync: the engine's int8 weights are the
    # policy's, cast and quantized.
    experience, _ = tr.build_experience(got, tr.score(got, {}))
    tr.update_epochs(experience)
    tr.sync_weights()
    from orion_tpu_torch.models.transformer import prep_decode_params
    want = prep_decode_params(tr.model.state_dict(), cfg.model, True)
    have = tr.engine.model.state_dict()
    assert have.keys() == want.keys()
    for name, t in want.items():
        assert torch.equal(have[name], t), name
