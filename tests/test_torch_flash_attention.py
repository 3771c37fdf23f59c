"""Kernel A of the PyTorch/CUDA port (orion_tpu_torch flash forward):
its plain version against the JAX package's ``flash_attention_gqa``,
which runs the Pallas kernel in interpret mode on the CPU.  Inputs are
made with numpy from fixed seeds and fed to both.

Tolerance: f32 on both sides, atol 1e-5 — the same math summed in a
different order (the Pallas kernel blocks the kv axis, the plain
version does one pass).  The CUDA kernel itself is held against the
plain version on the card in tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.ops.pallas.flash_attention import (
    flash_attention_gqa as jax_flash_attention_gqa)
from orion_tpu_torch.ops.flash_attention import (flash_attention_gqa,
                                                 flash_attention_reference)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(B, Lq, Lk, H, Hkv, D, seed, offsets=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Lq, H, D).astype(np.float32)
    k = rng.randn(B, Lk, Hkv, D).astype(np.float32)
    v = rng.randn(B, Lk, Hkv, D).astype(np.float32)
    if offsets is None:
        offsets = rng.randint(0, Lk - Lq + 1, B)
    pos = (np.asarray(offsets)[:, None]
           + np.arange(Lq)[None, :]).astype(np.int32)
    return q, k, v, pos


CASES = [
    # name, (B, Lq, Lk, H, Hkv, D), offsets (None = random per row)
    ("causal", (2, 16, 16, 2, 2, 16), [0, 0]),
    ("ragged_positions", (3, 8, 24, 2, 2, 16), None),
    ("gqa", (2, 12, 20, 4, 2, 16), None),
    ("verify_5_vs_388", (2, 5, 388, 2, 2, 16), [383, 117]),
    ("head_dim_64", (1, 8, 16, 2, 1, 64), None),
    # Tile edges of the card kernel (64-row warpgroup tiles, 128-row q
    # tiles, 64-slot kv tiles), at small D.
    ("len_1", (2, 1, 1, 2, 2, 16), [0, 0]),
    ("len_63", (2, 63, 63, 2, 2, 16), [0, 0]),
    ("len_64", (1, 64, 64, 2, 2, 16), [0]),
    ("len_65_gqa4", (2, 65, 65, 4, 1, 16), [0, 0]),
    ("len_129", (1, 129, 129, 2, 2, 16), [0]),
    ("q1_vs_129_gqa4", (2, 1, 129, 4, 1, 16), [128, 64]),
    ("q65_vs_129", (2, 65, 129, 2, 2, 16), None),
    # Slots 0..127 visible to every row, 128..199 straddle the rows'
    # frontiers.
    ("visible_beside_straddling", (1, 64, 200, 2, 2, 16), [136]),
    ("head_dim_128_len_65", (1, 65, 65, 2, 2, 128), [0]),
]


@pytest.mark.parametrize("name,shape,offsets", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_jax_flash(name, shape, offsets):
    B, Lq, Lk, H, Hkv, D = shape
    q, k, v, pos = _inputs(*shape, seed=len(name), offsets=offsets)
    scale = 1.0 / D ** 0.5
    expect = np.asarray(jax_flash_attention_gqa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        scale))
    tq, tk, tv, tp = (torch.from_numpy(x) for x in (q, k, v, pos))
    got = flash_attention_reference(tq, tk, tv, tp, scale)
    np.testing.assert_allclose(got.numpy(), expect, rtol=0, atol=ATOL)
    # On CPU tensors the wrapper IS the plain version.
    np.testing.assert_array_equal(
        flash_attention_gqa(tq, tk, tv, tp, scale).numpy(), got.numpy())


def test_q_tile_without_key_matches_jax():
    """Row 0's 129 queries all sit before every key (two whole card q
    tiles without a key), row 1's first 64: the port gives O = 0 and
    LSE <= -1e29 there; rows with a key agree with the JAX kernel.  (The
    JAX kernel gives mean(V) on a keyless row when its Pallas tile holds
    a row with a key; ROADMAP §3.)"""
    shape = (2, 129, 65, 2, 2, 16)
    q, k, v, pos = _inputs(*shape, seed=5, offsets=[-200, -64])
    scale = 0.25
    expect = np.asarray(jax_flash_attention_gqa(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        scale))
    got, lse = flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v, pos)), scale,
        return_lse=True)
    has_key = pos >= 0
    assert has_key.any() and not has_key[0].any()
    np.testing.assert_allclose(got.numpy()[has_key], expect[has_key],
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got.numpy()[~has_key], 0.0)
    assert (lse.numpy().transpose(0, 2, 1)[~has_key] <= -1e29).all()


def test_plain_lse_matches_numpy_logsumexp():
    """LSE [B, H, Lq] against a numpy log-sum-exp over the valid keys
    (f64 reference; atol 1e-5 for the f32 pass)."""
    B, Lq, Lk, H, Hkv, D = 2, 6, 20, 4, 2, 16
    q, k, v, pos = _inputs(B, Lq, Lk, H, Hkv, D, seed=11)
    scale = 0.25
    _, lse = flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v, pos)), scale,
        return_lse=True)
    kk = np.repeat(k, H // Hkv, axis=2).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) * scale
    valid = np.arange(Lk)[None, None, :] <= pos[:, :, None]
    s = np.where(valid[:, None], s, -np.inf)
    m = s.max(-1, keepdims=True)
    expect = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), expect, rtol=0, atol=ATOL)


def test_row_without_valid_key_gives_zero():
    """A query position below every kv slot (p < 0) has no valid key:
    O = 0 and LSE ~ -1e30, the neutral element the Pallas kernel gives."""
    q, k, v, pos = _inputs(1, 4, 8, 2, 2, 16, seed=3, offsets=[0])
    pos[0, 0] = -1
    out, lse = flash_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v, pos)), 0.25,
        return_lse=True)
    assert torch.all(out[0, 0] == 0)
    assert torch.all(lse[0, :, 0] < -1e29)
    assert torch.isfinite(out).all()

