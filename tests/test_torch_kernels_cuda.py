"""The PyTorch/CUDA port's hand-written kernels on the card, held against
their plain PyTorch versions (every test here needs a CUDA card and
skips without one).  This file imports neither JAX nor the JAX package,
so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Kernels A and A′ in bf16 run on the tensor cores (``wgmma``) over
64-row warpgroup tiles, 128-row q tiles and 64-slot kv tiles, so their
cases include lengths 1, 63, 64, 65 and 129, each head dim, GQA g = 4,
q tiles without any key and kv tiles that straddle the frontier; f32
keeps the CUDA-core body.

Tolerances: f32 kernels atol 1e-4 (f32 sums in another order over up
to a few hundred keys).  bf16 kernels: against an f32 evaluation of the
plain version, no worse than 2x the bf16 plain version's error (both
compute in f32 from the same bf16 inputs; only the output rounding and
the summation order differ).  Model gradients through kernels A, B and
C: within 1e-4 of their largest entry of the same f32 model with the
plain (reference) attention.  Kernels A′, B′ and C′ (ring chunks over
explicit kv positions) are held the same way on the rows that have a
valid key; on the others O and dQ must be exactly 0 and LSE <= -1e29.
Ring attention on the card: output within F32_ATOL of the
dense-per-chunk ring, gradients within 1e-4 of their largest entry of
autograd through it.
"""

import numpy as np
import pytest
import torch

from orion_tpu_torch.ops.flash_attention import (
    flash_attention_backward_reference, flash_attention_delta,
    flash_attention_gqa, flash_attention_reference, flash_bwd_dkv,
    flash_bwd_dq, flash_chunk_bwd_dkv, flash_chunk_bwd_dq, flash_chunk_fwd,
    flash_chunk_fwd_reference, flash_chunk_grads, flash_chunk_grads_reference)
from orion_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_int8,
    paged_decode_attention_reference)
from orion_tpu_torch.ops.quant import quantize_kv

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
    # Tile edges of the bf16 kernel (64-row warpgroup tiles, 128-row q
    # tiles, 64-slot kv tiles) at each head dim, GQA g = 4 among them.
    (2, 1, 1, 2, 2, 64, [0, 0]),
    (2, 63, 63, 8, 2, 128, [0, 0]),
    (2, 64, 64, 2, 2, 256, [0, 0]),
    (2, 65, 65, 8, 2, 64, [0, 0]),
    (2, 129, 129, 4, 4, 128, [0, 0]),
    (2, 1, 129, 4, 1, 256, [128, 64]),
    (2, 65, 129, 4, 1, 128, None),
    (2, 129, 65, 2, 2, 256, [-64, 0]),
    # Row 0's two q tiles have no key at all (positions < 0), row 1's
    # first warpgroup neither.
    (2, 129, 65, 4, 1, 64, [-200, -64]),
    # Slots 0..127 visible to every query, 128..199 straddle.
    (1, 64, 200, 4, 2, 128, [136]),
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


CHUNK = [
    # ring size S, rows per rank B, sequence L, H, Hkv, D, rotations,
    # kv positions shuffled within each row
    (4, 1, 256, 4, 2, 256, 1, False),
    (4, 2, 128, 8, 8, 128, 2, False),
    (2, 1, 96, 8, 2, 64, 1, False),   # 24-token chunks straddle tiles
    (4, 1, 128, 4, 4, 64, 3, True),
    # Zigzag chunks at the bf16 kernel's tile edges: 64, 66 and 130
    # tokens a rank (one kv tile, one past it, two past it), GQA g = 4.
    (4, 1, 256, 4, 1, 128, 1, False),
    (4, 1, 264, 8, 2, 256, 2, False),
    (4, 1, 520, 4, 1, 64, 1, False),
    (2, 1, 260, 8, 8, 128, 1, True),
]


def _chunk_case(shape, dtype):
    """One ring chunk on the card, stacked over the ranks: rank r's
    zigzag q positions against the keys of rank r - rotations, and a
    global LSE at or above the chunk's (finite on every row, as after a
    whole ring) with a merged O and dO."""
    from orion_tpu_torch.parallel import zigzag_order

    S, B, L, H, Hkv, D, rot, shuffle = shape
    rng = np.random.RandomState(L + D + rot)
    per = zigzag_order(L, S).reshape(S, L // S)
    qpos = np.repeat(per, B, axis=0)
    kvpos = np.repeat(np.roll(per, rot, axis=0), B, axis=0)
    if shuffle:
        kvpos = np.stack([rng.permutation(row) for row in kvpos])
    n, Ls = S * B, L // S
    q, k, v, out, dout = (
        torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda().to(dtype)
        for s in ((n, Ls, H, D), (n, Ls, Hkv, D), (n, Ls, Hkv, D),
                  (n, Ls, H, D), (n, Ls, H, D)))
    qpos, kvpos = (torch.from_numpy(x.astype(np.int32)).cuda()
                   for x in (qpos, kvpos))
    has_key = (kvpos[:, None, :] <= qpos[:, :, None]).any(-1)
    _, lse = flash_chunk_fwd_reference(q.float(), k.float(), v.float(),
                                       qpos, kvpos, D ** -0.5)
    bump = torch.from_numpy(rng.rand(n, H, Ls).astype(np.float32)).cuda()
    glse = torch.where(has_key[:, None, :], lse + bump, bump)
    return q, k, v, qpos, kvpos, out, dout, glse, has_key, D ** -0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CHUNK, ids=lambda s: "x".join(
    str(int(x)) for x in s))
def test_chunk_kernels_match_plain(shape, dtype):
    """A′ (O, LSE), B′ (dq) and C′ (dk, dv) against their plain versions
    on the same inputs; rows without a valid key give O = 0, LSE <=
    -1e29 and dQ = 0."""
    q, k, v, qpos, kvpos, out_g, dout, glse, has_key, scale = \
        _chunk_case(shape, dtype)
    counts = [fn.launches for fn in (flash_chunk_fwd, flash_chunk_bwd_dq,
                                     flash_chunk_bwd_dkv, flash_attention_gqa,
                                     flash_bwd_dq, flash_bwd_dkv)]
    out, lse = flash_chunk_fwd(q, k, v, qpos, kvpos, scale)
    grads = flash_chunk_grads(q, k, v, qpos, kvpos, out_g, glse, dout, scale)
    torch.cuda.synchronize()
    after = [fn.launches for fn in (flash_chunk_fwd, flash_chunk_bwd_dq,
                                    flash_chunk_bwd_dkv, flash_attention_gqa,
                                    flash_bwd_dq, flash_bwd_dkv)]
    assert [b - a for a, b in zip(counts, after)] == [1, 1, 1, 0, 0, 0]
    assert out.dtype == dtype and all(g.dtype == dtype for g in grads)
    plain_out, _ = flash_chunk_fwd_reference(q, k, v, qpos, kvpos, scale)
    ref_out, ref_lse = flash_chunk_fwd_reference(
        q.float(), k.float(), v.float(), qpos, kvpos, scale)
    _assert_close(out[has_key], plain_out[has_key], ref_out[has_key], dtype)
    assert (out[~has_key] == 0).all()
    rows = lse.transpose(1, 2)
    assert (rows[~has_key] <= -1e29).all()
    assert (rows[has_key] - ref_lse.transpose(1, 2)[has_key]).abs().max() \
        <= 1e-3
    plain = flash_chunk_grads_reference(q, k, v, qpos, kvpos, out_g, glse,
                                        dout, scale)
    ref = flash_chunk_grads_reference(q.float(), k.float(), v.float(), qpos,
                                      kvpos, out_g.float(), glse,
                                      dout.float(), scale)
    for got, pl, rf in zip(grads, plain, ref):
        _assert_close(got, pl, rf, dtype)
    assert (grads[0][~has_key] == 0).all()


CHUNK_EDGES = [
    # B, Lq, Lk, H, Hkv, D: A′ alone, positions drawn without repeats
    # from range(Lq + Lk), so tiles mix visible and invisible keys.
    (2, 1, 1, 2, 2, 64),
    (2, 63, 65, 8, 2, 128),
    (2, 64, 129, 4, 1, 256),
    (2, 129, 63, 4, 4, 64),
    (1, 65, 64, 2, 2, 256),
]


def _chunk_edge_inputs(shape, dtype, seed):
    B, Lq, Lk, H, Hkv, D = shape
    rng = np.random.RandomState(seed)
    qpos = np.stack([rng.permutation(Lq + Lk)[:Lq] for _ in range(B)])
    kvpos = np.stack([rng.permutation(Lq + Lk)[:Lk] for _ in range(B)])
    qpos[0, 0] = -1  # a row with no valid key
    kvpos[-1, 0] = qpos[-1].max()  # and one with a key
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()
               .to(dtype)
               for s in ((B, Lq, H, D), (B, Lk, Hkv, D), (B, Lk, Hkv, D)))
    qpos, kvpos = (torch.from_numpy(x.astype(np.int32)).cuda()
                   for x in (qpos, kvpos))
    return q, k, v, qpos, kvpos, D ** -0.5


def _check_chunk_fwd(q, k, v, qpos, kvpos, scale, dtype):
    before = flash_chunk_fwd.launches
    out, lse = flash_chunk_fwd(q, k, v, qpos, kvpos, scale)
    torch.cuda.synchronize()
    assert flash_chunk_fwd.launches == before + 1
    has_key = (kvpos[:, None, :] <= qpos[:, :, None]).any(-1)
    plain, _ = flash_chunk_fwd_reference(q, k, v, qpos, kvpos, scale)
    ref, ref_lse = flash_chunk_fwd_reference(q.float(), k.float(), v.float(),
                                             qpos, kvpos, scale)
    _assert_close(out[has_key], plain[has_key], ref[has_key], dtype)
    assert not has_key.all() and (out[~has_key] == 0).all()
    rows = lse.transpose(1, 2)
    assert (rows[~has_key] <= -1e29).all()
    assert (rows[has_key] - ref_lse.transpose(1, 2)[has_key]).abs().max() \
        <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", CHUNK_EDGES, ids=lambda s: "x".join(
    str(x) for x in s))
def test_chunk_fwd_kernel_at_tile_edges(shape, dtype):
    """A′ alone against its plain version at lengths around its tiles,
    keys in no order; rows without a valid key give O = 0, LSE <=
    -1e29."""
    _check_chunk_fwd(*_chunk_edge_inputs(shape, dtype, sum(shape)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_chunk_fwd_kernel_long_chunk(dtype):
    """A chunk of 1,026 kv tiles: the bf16 kernel keeps every tile's
    position range in shared memory sized from the tile count, skips
    the tiles no query sees and masks the late, early-position slots;
    the result still matches."""
    B, Lq, Lk, H, D = 1, 64, 1024 * 64 + 65, 1, 64
    rng = np.random.RandomState(9)
    qpos = np.sort(rng.permutation(Lk)[:Lq])
    kvpos = rng.permutation(Lk)
    kvpos[-70:] = rng.randint(0, 20, 70)  # late slots, early positions
    qpos[0] = -1
    q, k, v = (torch.from_numpy(rng.randn(B, L, H, D).astype(np.float32))
               .cuda().to(dtype) for L in (Lq, Lk, Lk))
    qpos, kvpos = (torch.from_numpy(x[None].astype(np.int32)).cuda()
                   for x in (qpos, kvpos))
    _check_chunk_fwd(q, k, v, qpos, kvpos, D ** -0.5, dtype)


def test_flash_forward_kernels_are_deterministic():
    """The bf16 forward kernels use no atomics and a fixed order: two
    launches on the same inputs give bitwise the same O and LSE."""
    B, Lq, Lk, H, Hkv, D, _ = FLASH[0]
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32)).cuda()
               .bfloat16()
               for s in ((B, Lq, H, D), (B, Lk, Hkv, D), (B, Lk, Hkv, D)))
    pos = torch.arange(Lk - Lq, Lk, dtype=torch.int32,
                       device="cuda")[None].repeat(B, 1)
    first = flash_attention_gqa(q, k, v, pos, 0.1, return_lse=True)
    second = flash_attention_gqa(q, k, v, pos, 0.1, return_lse=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    q, k, v, qpos, kvpos, scale = _chunk_edge_inputs(CHUNK_EDGES[2],
                                                     torch.bfloat16, 4)
    first = flash_chunk_fwd(q, k, v, qpos, kvpos, scale)
    second = flash_chunk_fwd(q, k, v, qpos, kvpos, scale)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_forward_kernels_refuse_misaligned_bf16_views():
    """The bf16 kernels read q, k and v in 16-byte units: a view whose
    base or head stride is not a multiple of 16 bytes raises (it is not
    copied behind the caller's back); the same views in f32 run."""
    pos = torch.arange(8, dtype=torch.int32, device="cuda")[None]
    wide = torch.randn(1, 8, 2, 68, device="cuda")
    flat = torch.randn(1 * 8 * 2 * 64 + 4, device="cuda")
    views = {
        "head stride 68": lambda t: t[..., :64],
        "base offset 8 bytes": lambda t: t[4:].view(1, 8, 2, 64),
    }
    for what, make in views.items():
        src = wide if what.startswith("head") else flat
        bad = make(src.bfloat16())
        ok = torch.randn(1, 8, 2, 64, device="cuda").bfloat16()
        for args in ((bad, ok, ok), (ok, bad, ok), (ok, ok, bad)):
            with pytest.raises(ValueError, match="16-byte aligned"):
                flash_attention_gqa(*args, pos, 0.125)
            with pytest.raises(ValueError, match="16-byte aligned"):
                flash_chunk_fwd(*args, pos, pos, 0.125)
        f32 = make(src)
        out = flash_attention_gqa(f32, f32, f32, pos, 0.125)
        ref = flash_attention_reference(f32, f32, f32, pos, 0.125)
        assert (out - ref).abs().max().item() <= F32_ATOL


def test_chunk_kernels_read_strided_inputs():
    """q/k/v views with non-packed batch/sequence strides go through A′,
    B′ and C′ without copies."""
    from orion_tpu_torch.parallel import zigzag_order

    rng = np.random.RandomState(4)
    big = torch.from_numpy(rng.randn(4, 40, 6, 64).astype(np.float32)).cuda()
    q, k, v = big[:, :32, 0:2], big[:, 4:36, 2:4], big[:, 8:40, 4:6]
    per = torch.from_numpy(zigzag_order(128, 4).reshape(4, 32).astype(
        np.int32)).cuda()
    kvpos = per.roll(1, dims=0)
    out, lse = flash_chunk_fwd(q, k, v, per, kvpos, 0.125)
    ref, ref_lse = flash_chunk_fwd_reference(q, k, v, per, kvpos, 0.125)
    assert (out - ref).abs().max().item() <= F32_ATOL
    dout = torch.from_numpy(rng.randn(4, 32, 2, 64).astype(np.float32)).cuda()
    glse = torch.clamp(ref_lse, min=0.0) + 1.0
    got = flash_chunk_grads(q, k, v, per, kvpos, ref, glse, dout, 0.125)
    want = flash_chunk_grads_reference(q, k, v, per, kvpos, ref, glse, dout,
                                       0.125)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= F32_ATOL


def test_ring_attention_on_card_matches_reference():
    """ring_attention on a StackedRing(4) on the card goes through A′, B′
    and C′ only (4 launches each), and its output and q/k/v gradients
    agree with the dense-per-chunk ring under autograd."""
    from orion_tpu_torch.parallel import (StackedRing, ring_attention,
                                          ring_attention_reference)

    ring = StackedRing(4)
    rng = np.random.RandomState(6)
    B, L, H, Hkv, D = 2, 256, 4, 2, 64
    x = {n: torch.from_numpy(rng.randn(B, L, h, D).astype(np.float32))
         .cuda() for n, h in (("q", H), ("k", Hkv), ("v", Hkv), ("do", H))}
    pos = ring.shard(torch.arange(L, device="cuda")[None].expand(B, L))
    grads = {}
    for name, fn in (("ring", ring_attention),
                     ("reference", ring_attention_reference)):
        leaves = [ring.shard(x[n]).requires_grad_() for n in "qkv"]
        counts = [f.launches for f in (flash_chunk_fwd, flash_chunk_bwd_dq,
                                       flash_chunk_bwd_dkv,
                                       flash_attention_gqa)]
        out = fn(*leaves, pos, pos, D ** -0.5, ring)
        g = torch.autograd.grad(out, leaves, ring.shard(x["do"]))
        torch.cuda.synchronize()
        after = [f.launches for f in (flash_chunk_fwd, flash_chunk_bwd_dq,
                                      flash_chunk_bwd_dkv,
                                      flash_attention_gqa)]
        grads[name] = (out.detach(), *g)
        if name == "ring":
            assert [b - a for a, b in zip(counts, after)] == [4, 4, 4, 0]
    assert (grads["ring"][0] - grads["reference"][0]).abs().max().item() \
        <= F32_ATOL
    for got, want in zip(grads["ring"][1:], grads["reference"][1:]):
        tol = 1e-4 * want.abs().max().item()
        assert (got - want).abs().max().item() <= tol


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", PAGED, ids=lambda s: "x".join(
    str(x) for x in s))
def test_paged_int8_kernel_matches_plain(shape, dtype):
    """Kernel D' (int8 pools, f32 per-slot scales) against its plain
    version; one more launch on D''s count and none on D's."""
    B, H, Hkv, D, ps, mp = shape
    rng = np.random.RandomState(B + D + 1)
    n = B * mp + 1
    q = torch.from_numpy(rng.randn(B, H, D).astype(np.float32)).cuda()
    pools = []
    for _ in range(2):
        x = torch.from_numpy(rng.randn(n, Hkv, ps, D).astype(np.float32))
        xq, xs = quantize_kv(x.cuda())
        pools += [xq, xs[:, :, None, :].contiguous()]
    kp, ks, vp, vs = pools
    bt = (rng.permutation(n - 1)[:B * mp] + 1).reshape(B, mp)
    lens = rng.randint(1, ps * mp + 1, B)
    lens[0] = 1
    lens[-1] = ps * (mp - 1) + 1      # one token on its last page
    used = (lens + ps - 1) // ps
    for b in range(B):
        bt[b, used[b]:] = 0  # padding pages point at page 0
    bt = torch.from_numpy(bt.astype(np.int32)).cuda()
    lens = torch.from_numpy(lens.astype(np.int32)).cuda()
    q = q.to(dtype)
    d0, q0 = (paged_decode_attention.launches,
              paged_decode_attention_int8.launches)
    out = paged_decode_attention_int8(q, kp, vp, ks, vs, bt, lens, D ** -0.5)
    assert (paged_decode_attention.launches,
            paged_decode_attention_int8.launches) == (d0, q0 + 1)
    assert out.dtype == dtype
    kw = {"k_scales": ks, "v_scales": vs}
    plain = paged_decode_attention_reference(q, kp, vp, bt, lens,
                                             D ** -0.5, **kw)
    ref = paged_decode_attention_reference(q.float(), kp, vp, bt, lens,
                                           D ** -0.5, **kw)
    _assert_close(out, plain, ref, dtype)


def test_paged_int8_kernel_refuses_float_pools_and_missing_scales():
    q = torch.zeros(2, 4, 64, device="cuda")
    pool = torch.zeros(3, 4, 16, 64, device="cuda")
    scales = torch.ones(3, 4, 1, 16, device="cuda")
    bt = torch.zeros(2, 1, dtype=torch.int32, device="cuda")
    lens = torch.ones(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="int8 pools take scales"):
        paged_decode_attention_int8(q, pool, pool, scales, scales, bt, lens,
                                    0.125)
    with pytest.raises(ValueError, match="need k_scales"):
        paged_decode_attention(q, pool.to(torch.int8), pool.to(torch.int8),
                               bt, lens, 0.125)


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
    """The port's engine on the card (kernels A and D; solo requests and
    groups of 2 clones) gives the same greedy tokens as on the CPU
    (plain versions), tiny f32 model."""
    _engine_card_vs_cpu(int8=False)


def test_int8_engine_on_card_matches_engine_on_cpu():
    """The same with int8 weights and int8 pools: kernels A and D' on the
    card, D never.  Each device quantizes its own K and V, whose f32
    values differ in the last bits, so an element may round to the
    neighbouring int8 step (~1% of its vector's largest entry):
    logprobs within INT8_LP_ATOL, tokens identical."""
    _engine_card_vs_cpu(int8=True)


INT8_LP_ATOL = 1e-2


def _engine_card_vs_cpu(int8):
    from orion_tpu_torch.config import ModelConfig, RolloutConfig
    from orion_tpu_torch.models import Transformer
    from orion_tpu_torch.rollout.continuous import ContinuousBatchingEngine

    cfg = ModelConfig.tiny("llama", dtype="float32", hidden_size=256,
                           num_heads=4, num_kv_heads=2)
    rcfg = RolloutConfig(max_prompt_len=24, max_new_tokens=12,
                         temperature=0.0, page_size=16, max_batch_size=3,
                         quantize_weights=int8, quantize_kv=int8)
    rng = np.random.RandomState(1)
    reqs = [(i, rng.randint(1, cfg.vocab_size, rng.randint(3, 24)))
            for i in range(5)]
    reqs += [(10 + 2 * i, rng.randint(1, cfg.vocab_size, 20), None, 2)
             for i in range(2)]
    decode = paged_decode_attention_int8 if int8 else paged_decode_attention
    d_before = paged_decode_attention.launches
    cpu_model = Transformer(cfg, device="cpu")
    card_model = Transformer(cfg, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    out = {}
    launches = {}
    for dev, model in (("cpu", cpu_model), ("cuda", card_model)):
        eng = ContinuousBatchingEngine(model, cfg, rcfg, segment_len=4,
                                       device=dev)
        f0, p0 = flash_attention_gqa.launches, decode.launches
        out[dev] = {r.req_id: r for r in eng.generate(reqs)}
        launches[dev] = (flash_attention_gqa.launches - f0,
                         decode.launches - p0)
    assert launches["cpu"] == (0, 0)
    assert min(launches["cuda"]) > 0
    if int8:
        assert paged_decode_attention.launches == d_before
    for i in out["cpu"]:
        np.testing.assert_array_equal(out["cuda"][i].tokens,
                                      out["cpu"][i].tokens)
        np.testing.assert_allclose(out["cuda"][i].logprobs,
                                   out["cpu"][i].logprobs,
                                   atol=INT8_LP_ATOL if int8 else F32_ATOL)
