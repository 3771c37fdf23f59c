"""int8 serving in the PyTorch/CUDA port (``orion_tpu_torch``) against the
JAX package: the quantizers of ``ops/quant.py``, the plain version of
kernel D' (paged decode over int8 pools), the int8 paged-KV write and
gather, ``QuantLinear`` and the quantized tiny model, the weight prep,
and the continuous engine with ``quantize_weights`` and ``quantize_kv``.
Inputs are made with numpy from fixed seeds and fed to both packages;
JAX's D' runs as its own tests run it on the CPU (the Pallas kernel in
interpret mode with ``force_kernel=True``, and its plain reference).

Tolerances (f32 on both sides unless stated):
- quantizers: int8 values differ by at most 1, in at most 1e-4 of the
  entries (a division landing on a rounding tie); scales rtol 1e-6;
- D' plain version: atol 1e-5 against the Pallas kernel (online softmax
  page by page) and its reference (one pass);
- quantized model logits: atol 1e-5 (the same int8 weights and scales;
  sums taken in another order);
- int8 engine at greedy: tokens identical, logprobs atol 1e-4 (as the
  bf16 engine tests).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.config import ModelConfig as JaxModelConfig
from orion_tpu.config import RolloutConfig as JaxRolloutConfig
from orion_tpu.models import Transformer as JaxTransformer
from orion_tpu.models import init_params
from orion_tpu.models.transformer import (
    prep_decode_params as jax_prep_decode_params)
from orion_tpu.ops.paged_kv import gather_paged_kv as jax_gather
from orion_tpu.ops.paged_kv import init_paged_cache as jax_init
from orion_tpu.ops.paged_kv import write_paged_tokens as jax_write
from orion_tpu.ops.pallas.paged_attention import (
    paged_decode_attention_int8 as jax_decode_int8)
from orion_tpu.ops.pallas.paged_attention import (
    paged_decode_attention_reference as jax_decode_reference)
from orion_tpu.ops.quant import quantize_kernel as jax_quantize_kernel
from orion_tpu.ops.quant import quantize_kv as jax_quantize_kv
from orion_tpu.ops.quant import quantize_params_int8 as jax_quantize_params
from orion_tpu.rollout.continuous import (
    ContinuousBatchingEngine as JaxEngine)
from orion_tpu_torch.config import ModelConfig, RolloutConfig
from orion_tpu_torch.models.convert import load_jax_params
from orion_tpu_torch.models.transformer import (QuantLinear,
                                                prep_decode_params)
from orion_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_int8,
    paged_decode_attention_reference)
from orion_tpu_torch.ops.paged_kv import (gather_paged_kv, init_paged_cache,
                                          write_paged_tokens)
from orion_tpu_torch.ops.quant import (dequant_kv, quantize_kernel,
                                       quantize_kv)
from orion_tpu_torch.rollout.continuous import ContinuousBatchingEngine

D_ATOL = 1e-5
LOGIT_ATOL = 1e-5
LP_ATOL = 1e-4
INT8_FLIP_SHARE = 1e-4
SCALE_RTOL = 1e-6

ARCHS = {
    "neox": dict(rotary_pct=0.25, use_parallel_residual=True,
                 attn_bias=True, mlp_bias=True),
    "llama": dict(),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _assert_int8_close(got, expect):
    diff = np.abs(got.astype(np.int32) - expect.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= INT8_FLIP_SHARE


# -- the quantizers --------------------------------------------------------

def test_quantize_kernel_matches_jax():
    """Per-output-channel int8 over a flax [in, out] kernel and the
    port's [out, in] weight; one channel all zeros (scale from 1e-8)."""
    rng = np.random.RandomState(0)
    kernel = (rng.randn(96, 80) * rng.uniform(0.01, 2, 80)).astype(
        np.float32)
    kernel[:, 3] = 0.0
    jq, js = jax_quantize_kernel(jnp.asarray(kernel))
    tq, ts = quantize_kernel(torch.from_numpy(kernel.T.copy()))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _assert_int8_close(tq.numpy().T, np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCALE_RTOL)


def test_quantize_kv_matches_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 7, 2, 16) * 3).astype(np.float32)
    jq, js = jax_quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(torch.from_numpy(x))
    _assert_int8_close(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCALE_RTOL)
    back = dequant_kv(tq, ts, torch.float32).numpy()
    assert np.abs(back - x).max() <= ts.numpy().max() / 2 * 1.0001


# -- kernel D' (plain version) ---------------------------------------------

def _int8_setup(B, H, Hkv, D, ps, max_pages, seed):
    """int8 pools with f32 scale pools (page 0 reserved for padding),
    non-contiguous page tables and ragged lengths: the first sequence
    has one token, the second ends inside its last page."""
    rng = np.random.RandomState(seed)
    n = B * max_pages + 1
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randint(-127, 128, (n, Hkv, ps, D)).astype(np.int8)
    vp = rng.randint(-127, 128, (n, Hkv, ps, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, (n, Hkv, 1, ps)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, (n, Hkv, 1, ps)).astype(np.float32)
    bt = (rng.permutation(n - 1)[:B * max_pages] + 1).reshape(
        B, max_pages).astype(np.int32)
    lens = rng.randint(1, ps * max_pages + 1, B).astype(np.int32)
    lens[0] = 1
    lens[1] = ps * (max_pages - 1) + ps // 2 + 1
    used = (lens + ps - 1) // ps
    for b in range(B):
        bt[b, used[b]:] = 0
    return q, kp, vp, ks, vs, bt, lens


@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["neox", "gqa"])
def test_int8_decode_plain_matches_jax(heads):
    H, Hkv = heads
    q, kp, vp, ks, vs, bt, lens = _int8_setup(4, H, Hkv, 16, 8, 3, H)
    scale = 0.25
    j = [jnp.asarray(x) for x in (q, kp, vp, ks, vs, bt, lens)]
    kernel = np.asarray(jax_decode_int8(*j, scale, force_kernel=True))
    reference = np.asarray(jax_decode_reference(
        j[0], j[1], j[2], j[5], j[6], scale, k_scales=j[3], v_scales=j[4]))
    t = [torch.from_numpy(x) for x in (q, kp, vp, ks, vs, bt, lens)]
    got = paged_decode_attention_int8(*t, scale)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), kernel, rtol=0, atol=D_ATOL)
    np.testing.assert_allclose(got.numpy(), reference, rtol=0, atol=D_ATOL)
    # The wrapper with scales is the same call.
    np.testing.assert_array_equal(
        paged_decode_attention(t[0], t[1], t[2], t[5], t[6], scale,
                               k_scales=t[3], v_scales=t[4]).numpy(),
        paged_decode_attention_reference(t[0], t[1], t[2], t[5], t[6],
                                         scale, k_scales=t[3],
                                         v_scales=t[4]).numpy())


def test_int8_write_and_gather_match_jax():
    """Quantize-on-write into int8 pools (values and scales scattered at
    ragged positions), then the dequantizing gather."""
    rng = np.random.RandomState(2)
    B, L, Hkv, D, ps = 2, 5, 2, 8, 4
    jc = jax_init(1, B, 12, Hkv, D, ps, quantized=True)[0]
    tc = init_paged_cache(1, B, 12, Hkv, D, ps, device="cpu",
                          quantized=True)[0]
    assert tc["k_pages"].dtype == torch.int8
    assert tuple(tc["k_scales"].shape) == tuple(jc["k_scales"].shape)
    k = rng.randn(B, L, Hkv, D).astype(np.float32)
    v = rng.randn(B, L, Hkv, D).astype(np.float32)
    pos = np.stack([np.arange(L), 3 + np.arange(L)]).astype(np.int32)
    jc = jax_write(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    write_paged_tokens(tc, torch.from_numpy(k), torch.from_numpy(v),
                       torch.from_numpy(pos))
    for key in ("k_pages", "v_pages"):
        _assert_int8_close(tc[key].numpy(), np.asarray(jc[key]))
    for key in ("k_scales", "v_scales"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=SCALE_RTOL)
    jk, jv = jax_gather(jc, jnp.float32)
    tk, tv = gather_paged_kv(tc, torch.float32)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


# -- QuantLinear, the quantized model, the weight prep -----------------------

def _tree(arch):
    """(JAX config, model, f32 numpy tree with perturbed biases and norm
    scales)."""
    jcfg = JaxModelConfig.tiny(arch, dtype="float32", **ARCHS[arch])
    model = JaxTransformer(jcfg)
    tree = jax.tree.map(np.asarray,
                        init_params(model, jax.random.key(0), jcfg))
    rng = np.random.RandomState(1)
    tree = jax.tree.map(
        lambda x: (x + 0.05 * rng.randn(*x.shape)).astype(np.float32), tree)
    return jcfg, model, tree


def test_quant_linear_matches_quant_dense():
    from orion_tpu.models.transformer import QuantDense

    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 24).astype(np.float32)
    kq, scale = jax_quantize_kernel(jnp.asarray(
        rng.randn(24, 40).astype(np.float32)))
    bias = rng.randn(40).astype(np.float32)
    dense = QuantDense(features=40, use_bias=True, dtype=jnp.float32,
                       param_dtype=jnp.float32)
    expect = dense.apply({"params": {"kernel_q": kq, "scale": scale,
                                     "bias": jnp.asarray(bias)}},
                         jnp.asarray(x))
    lin = QuantLinear(24, 40, True, torch.float32)
    with torch.no_grad():
        lin.weight_q.copy_(torch.from_numpy(np.asarray(kq).T.copy()))
        lin.scale.copy_(torch.from_numpy(np.array(scale)))
        lin.bias.copy_(torch.from_numpy(bias))
        got = lin(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_quantized_model_matches_jax(arch):
    """The tree of ``quantize_params_int8`` loads straight into a port
    model built with ``quantize_dense=True``; logits match the JAX
    quantized model's (the LM head quantized too)."""
    jcfg, _, tree = _tree(arch)
    qtree = jax.tree.map(np.asarray, jax_quantize_params(
        jax.tree.map(jnp.asarray, tree)))
    qmodel = JaxTransformer(dataclasses.replace(jcfg, quantize_dense=True))
    cfg = ModelConfig.tiny(arch, dtype="float32", quantize_dense=True,
                           **ARCHS[arch])
    port = load_jax_params(qtree, cfg, device="cpu")
    assert isinstance(port.lm_head, QuantLinear)
    assert port.layers[0].attn.q_proj.weight_q.dtype == torch.int8
    rng = np.random.RandomState(4)
    ids = rng.randint(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), ids.shape).copy()
    expect, _ = qmodel.apply({"params": jax.tree.map(jnp.asarray, qtree)},
                             jnp.asarray(ids), jnp.asarray(pos))
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=0,
                               atol=LOGIT_ATOL)
    with pytest.raises(ValueError, match="quantize_dense"):
        load_jax_params(qtree, ModelConfig.tiny(arch, dtype="float32",
                                                **ARCHS[arch]),
                        device="cpu")


def test_prep_decode_params_matches_jax():
    """Cast to the compute dtype (bf16) FIRST, then quantize: the scales
    come from bf16 values, as in the JAX engine.  Preparing a prepared
    dict changes nothing."""
    jcfg, _, tree = _tree("neox")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg = ModelConfig.tiny("neox", **ARCHS["neox"])
    port = load_jax_params(tree, ModelConfig.tiny(
        "neox", dtype="float32", **ARCHS["neox"]), device="cpu")
    expect = jax_prep_decode_params(jax.tree.map(jnp.asarray, tree), jcfg,
                                    quantize_weights=True)
    got = prep_decode_params(port.state_dict(), cfg, quantize_weights=True)
    assert prep_decode_params(got, cfg, True).keys() == got.keys()
    node = expect["layers_1"]["mlp"]["up_proj"]
    _assert_int8_close(got["layers.1.mlp.up_proj.weight_q"].numpy().T,
                       np.asarray(node["kernel_q"]))
    np.testing.assert_allclose(got["layers.1.mlp.up_proj.scale"].numpy(),
                               np.asarray(node["scale"]), rtol=SCALE_RTOL)
    assert got["layers.1.mlp.up_proj.bias"].dtype == torch.bfloat16
    assert got["embed.weight"].dtype == torch.bfloat16
    assert "lm_head.weight_q" in got and "embed.weight_q" not in got


# -- the int8 continuous engine --------------------------------------------

def _engines(arch, **kw):
    jcfg, jmodel, tree = _tree(arch)
    rc = dict(max_prompt_len=12, max_new_tokens=10, temperature=0.0,
              page_size=4, max_batch_size=3, quantize_weights=True,
              quantize_kv=True, **kw)
    jax_eng = JaxEngine(jmodel, jcfg, JaxRolloutConfig(prefix_cache=False,
                                                       **rc),
                        segment_len=4)
    cfg = ModelConfig.tiny(arch, dtype="float32", **ARCHS[arch])
    eng = ContinuousBatchingEngine(load_jax_params(tree, cfg, device="cpu"),
                                   cfg, RolloutConfig(**rc), segment_len=4,
                                   device="cpu")
    return jax_eng, eng, jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_int8_engine_matches_jax(arch):
    """int8 weights and int8 pools, 6 ragged requests through 3 slots:
    greedy tokens identical to the JAX engine with the same flags."""
    jax_eng, eng, params = _engines(arch)
    layer0 = eng._pools[0]
    assert layer0["k_pages"].dtype == torch.int8
    assert layer0["k_scales"].shape == (eng.num_pages + 1,
                                        eng.mc.num_kv_heads, 1, 4)
    assert eng.model.layers[0].mlp.up_proj.weight_q.dtype == torch.int8
    rng = np.random.RandomState(5)
    reqs = [(i, rng.randint(1, 256, rng.randint(2, 12)).astype(np.int32))
            for i in range(6)]
    expect = {r.req_id: r for r in jax_eng.generate(
        reqs, jax.random.key(1), params)}
    got = {r.req_id: r for r in eng.generate(reqs, seed=1)}
    assert sorted(got) == sorted(expect)
    for i, r in expect.items():
        np.testing.assert_array_equal(got[i].tokens, r.tokens,
                                      err_msg=f"req {i}")
        np.testing.assert_allclose(got[i].logprobs, r.logprobs, rtol=0,
                                   atol=LP_ATOL, err_msg=f"req {i}")
        np.testing.assert_allclose(got[i].policy_logprobs,
                                   r.policy_logprobs, rtol=0,
                                   atol=LP_ATOL, err_msg=f"req {i}")
