"""The PyTorch/CUDA port's hand-written kernels on the card, held against
their plain PyTorch versions (every test here needs a CUDA card and
skips without one).  This file imports neither JAX nor the JAX package,
so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerances: f32 kernels atol 1e-4 (f32 sums in another order over up
to a few hundred keys).  bf16 kernels: against an f32 evaluation of the
plain version, no worse than 2x the bf16 plain version's error (both
compute in f32 from the same bf16 inputs; only the output rounding and
the summation order differ).  Model gradients through kernels A, B and
C: within 1e-4 of their largest entry of the same f32 model with the
plain (reference) attention.
"""

import numpy as np
import pytest
import torch

from orion_tpu_torch.ops.flash_attention import (
    flash_attention_backward_reference, flash_attention_delta,
    flash_attention_gqa, flash_attention_reference, flash_bwd_dkv,
    flash_bwd_dq)
from orion_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_reference)

pytestmark = pytest.mark.cuda

F32_ATOL = 1e-4
BF16_FACTOR = 2.0


@pytest.fixture(autouse=True)
def _card_and_threads():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _assert_close(out, plain, ref, dtype):
    out, plain = out.float(), plain.float()
    assert torch.isfinite(out).all()
    err = (out - ref).abs().max().item()
    if dtype == torch.float32:
        assert err <= F32_ATOL, err
    else:
        assert err <= BF16_FACTOR * (plain - ref).abs().max().item(), err


FLASH = [
    # B, Lq, Lk, H, Hkv, D, offsets (None = random per row)
    (2, 40, 100, 4, 2, 256, None),
    (2, 33, 33, 2, 2, 128, [0, 0]),
    (3, 5, 388, 8, 8, 256, [383, 0, 200]),
    (2, 64, 80, 8, 2, 64, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FLASH, ids=lambda s: "x".join(
    str(x) for x in s[:6]))
def test_flash_kernel_matches_plain(shape, dtype):
    B, Lq, Lk, H, Hkv, D, offsets = shape
    rng = np.random.RandomState(B * Lq + D)
    if offsets is None:
        offsets = rng.randint(0, Lk - Lq + 1, B)
    pos = torch.from_numpy((np.asarray(offsets)[:, None]
                            + np.arange(Lq)[None, :]).astype(np.int32))
    pos[0, 0] = -1  # a row with no valid key: O = 0, LSE ~ -1e30
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((B, Lq, H, D), (B, Lk, Hkv, D), (B, Lk, Hkv, D)))
    q, k, v, pos = (t.cuda() for t in (q, k, v, pos))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    scale = D ** -0.5
    before = flash_attention_gqa.launches
    out, lse = flash_attention_gqa(q, k, v, pos, scale, return_lse=True)
    assert flash_attention_gqa.launches == before + 1
    plain = flash_attention_reference(q, k, v, pos, scale)
    ref, lse_ref = flash_attention_reference(q.float(), k.float(), v.float(),
                                             pos, scale, return_lse=True)
    _assert_close(out, plain, ref, dtype)
    assert (out[0, 0] == 0).all() and (lse[0, :, 0] < -1e29).all()
    assert (lse - lse_ref).abs().max().item() <= 1e-3


def test_flash_kernel_reads_strided_inputs():
    """q/k/v views with non-packed batch/sequence strides (slices of a
    wider tensor) go through the kernel without copies."""
    rng = np.random.RandomState(0)
    big = torch.from_numpy(rng.randn(2, 24, 6, 64).astype(np.float32)).cuda()
    q, k, v = big[:, :20, 0:2], big[:, :, 2:4], big[:, :, 4:6]
    pos = torch.arange(20, dtype=torch.int32, device="cuda")[None].repeat(2, 1)
    out = flash_attention_gqa(q, k, v, pos, 0.125)
    ref = flash_attention_reference(q, k, v, pos, 0.125)
    assert (out - ref).abs().max().item() <= F32_ATOL


def test_kernels_refuse_unsupported_head_dim():
    q = torch.zeros(1, 4, 2, 16, device="cuda")
    pos = torch.zeros(1, 4, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_gqa(q, q, q, pos, 0.25)


def _backward_case(shape, dtype):
    """Inputs, kernel A's O and LSE, and a cotangent for one FLASH
    shape; the first row's first query has no valid key."""
    B, Lq, Lk, H, Hkv, D, offsets = shape
    rng = np.random.RandomState(B * Lq + D + 1)
    if offsets is None:
        offsets = rng.randint(0, Lk - Lq + 1, B)
    pos = torch.from_numpy((np.asarray(offsets)[:, None]
                            + np.arange(Lq)[None, :]).astype(np.int32))
    pos[0, 0] = -1
    q, k, v, dout = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                     .cuda().to(dtype)
                     for s in ((B, Lq, H, D), (B, Lk, Hkv, D),
                               (B, Lk, Hkv, D), (B, Lq, H, D)))
    pos = pos.cuda()
    scale = D ** -0.5
    out, lse = flash_attention_gqa(q, k, v, pos, scale, return_lse=True)
    return q, k, v, pos, dout, out, lse, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FLASH, ids=lambda s: "x".join(
    str(x) for x in s[:6]))
def test_flash_backward_kernels_match_plain(shape, dtype):
    """Kernels B (dq) and C (dk, dv) against the plain backward on the
    same O and LSE, GQA shapes included."""
    q, k, v, pos, dout, out, lse, scale = _backward_case(shape, dtype)
    delta = flash_attention_delta(out, dout)
    b0, c0 = flash_bwd_dq.launches, flash_bwd_dkv.launches
    dq = flash_bwd_dq(q, k, v, pos, dout, lse, delta, scale)
    dk, dv = flash_bwd_dkv(q, k, v, pos, dout, lse, delta, scale)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (b0 + 1,
                                                               c0 + 1)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    plain = flash_attention_backward_reference(q, k, v, pos, out, lse, dout,
                                               scale)
    ref = flash_attention_backward_reference(
        q.float(), k.float(), v.float(), pos, out.float(), lse,
        dout.float(), scale)
    for got, pl, rf in zip((dq, dk, dv), plain, ref):
        _assert_close(got, pl, rf, dtype)
    assert (dq[0, 0] == 0).all()


def test_flash_backward_kernels_are_deterministic():
    """No atomics: two launches give bitwise the same gradients."""
    q, k, v, pos, dout, out, lse, scale = _backward_case(FLASH[3],
                                                         torch.bfloat16)
    delta = flash_attention_delta(out, dout)
    first = (flash_bwd_dq(q, k, v, pos, dout, lse, delta, scale),
             *flash_bwd_dkv(q, k, v, pos, dout, lse, delta, scale))
    second = (flash_bwd_dq(q, k, v, pos, dout, lse, delta, scale),
              *flash_bwd_dkv(q, k, v, pos, dout, lse, delta, scale))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_model_grads_through_kernels_match_reference():
    """A backward through the model on the card reaches q_proj, k_proj
    and v_proj (through kernels A, B and C) and gives the gradients of
    the same model with the plain attention."""
    import dataclasses

    from orion_tpu_torch.config import ModelConfig
    from orion_tpu_torch.models import Transformer

    cfg = ModelConfig.tiny("llama", dtype="float32", hidden_size=256,
                           num_heads=4, num_kv_heads=2)
    model = Transformer(cfg, device="cuda", seed=1)
    ref = Transformer(dataclasses.replace(cfg, attention_impl="reference"),
                      device="cuda")
    ref.load_state_dict(model.state_dict())
    rng = np.random.RandomState(2)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 37))).cuda()
    pos = torch.arange(37, device="cuda")[None].expand(2, 37)
    counts = (flash_attention_gqa.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    grads = {}
    for name, m in (("kernels", model), ("reference", ref)):
        logits = m(ids, pos)
        loss = torch.log_softmax(logits, -1)[..., 3].mean()
        loss.backward()
        grads[name] = {n: p.grad for n, p in m.named_parameters()}
    after = (flash_attention_gqa.launches, flash_bwd_dq.launches,
             flash_bwd_dkv.launches)
    assert [b - a for a, b in zip(counts, after)] == [cfg.num_layers] * 3
    for i in range(cfg.num_layers):
        for proj in ("q_proj", "k_proj", "v_proj"):
            assert getattr(model.layers[i].attn, proj).weight.grad \
                is not None
    for n, g in grads["kernels"].items():
        r = grads["reference"][n]
        tol = 1e-4 * r.abs().max().item()
        assert (g - r).abs().max().item() <= tol, n


PAGED = [
    # B, H, Hkv, D, ps, max_pages
    (4, 8, 2, 256, 64, 3),
    (5, 8, 8, 256, 64, 10),
    (6, 32, 8, 64, 16, 5),
    (3, 4, 4, 128, 32, 4),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", PAGED, ids=lambda s: "x".join(
    str(x) for x in s))
def test_paged_kernel_matches_plain(shape, dtype):
    B, H, Hkv, D, ps, mp = shape
    rng = np.random.RandomState(B + D)
    n = B * mp + 1
    q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32))
    kp = torch.from_numpy(rng.randn(n, Hkv, ps, D).astype(np.float32))
    vp = torch.from_numpy(rng.randn(n, Hkv, ps, D).astype(np.float32))
    bt = (rng.permutation(n - 1)[:B * mp] + 1).reshape(B, mp)
    lens = rng.randint(1, ps * mp + 1, B)
    lens[0] = 1
    used = (lens + ps - 1) // ps
    for b in range(B):
        bt[b, used[b]:] = 0  # padding pages point at page 0
    bt = torch.from_numpy(bt.astype(np.int32)).cuda()
    lens = torch.from_numpy(lens.astype(np.int32)).cuda()
    q, kp, vp = (t.cuda().to(dtype) for t in (q, kp, vp))
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, kp, vp, bt, lens, D ** -0.5)
    assert paged_decode_attention.launches == before + 1
    plain = paged_decode_attention_reference(q, kp, vp, bt, lens, D ** -0.5)
    ref = paged_decode_attention_reference(q.float(), kp.float(), vp.float(),
                                           bt, lens, D ** -0.5)
    _assert_close(out, plain, ref, dtype)


def test_paged_kernel_clamps_length_past_table():
    """A seq_len beyond max_pages * ps reads only the table's pages, as
    the plain version (which gathers max_pages pages) does."""
    B, H, Hkv, D, ps, mp = 2, 4, 4, 64, 16, 3
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    q = torch.randn(B, H, D, generator=gen, device="cuda")
    kp = torch.randn(B * mp + 1, Hkv, ps, D, generator=gen, device="cuda")
    vp = torch.randn(B * mp + 1, Hkv, ps, D, generator=gen, device="cuda")
    bt = torch.arange(1, B * mp + 1, dtype=torch.int32,
                      device="cuda").reshape(B, mp)
    lens = torch.tensor([mp * ps + 1, 10 * mp * ps], dtype=torch.int32,
                        device="cuda")
    out = paged_decode_attention(q, kp, vp, bt, lens, D ** -0.5)
    ref = paged_decode_attention_reference(q, kp, vp, bt, lens, D ** -0.5)
    torch.cuda.synchronize()
    _assert_close(out, ref, ref, torch.float32)


def test_engine_on_card_matches_engine_on_cpu():
    """The port's engine on the card (both kernels on its path) gives the
    same greedy tokens as on the CPU (plain versions), tiny f32 model."""
    from orion_tpu_torch.config import ModelConfig, RolloutConfig
    from orion_tpu_torch.models import Transformer
    from orion_tpu_torch.rollout.continuous import ContinuousBatchingEngine

    cfg = ModelConfig.tiny("llama", dtype="float32", hidden_size=256,
                           num_heads=4, num_kv_heads=2)
    rcfg = RolloutConfig(max_prompt_len=24, max_new_tokens=12,
                         temperature=0.0, page_size=16, max_batch_size=3)
    rng = np.random.RandomState(1)
    reqs = [(i, rng.randint(1, cfg.vocab_size, rng.randint(3, 24)))
            for i in range(5)]
    cpu_model = Transformer(cfg, device="cpu")
    card_model = Transformer(cfg, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    out = {}
    launches = {}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
        eng = ContinuousBatchingEngine(model, cfg, rcfg, segment_len=4,
                                       device=dev)
        f0, p0 = (flash_attention_gqa.launches,
                  paged_decode_attention.launches)
        out[dev] = {r.req_id: r for r in eng.generate(reqs)}
        launches[dev] = (flash_attention_gqa.launches - f0,
                         paged_decode_attention.launches - p0)
    assert launches["cpu"] == (0, 0)
    assert min(launches["cuda"]) > 0
    for i in out["cpu"]:
        np.testing.assert_array_equal(out["cuda"][i].tokens,
                                      out["cpu"][i].tokens)
        np.testing.assert_allclose(out["cuda"][i].logprobs,
                                   out["cpu"][i].logprobs, atol=F32_ATOL)
