"""Kernel B of the PyTorch/CUDA port (orion_tpu_torch paged decode): its
plain version against the JAX package's ``paged_decode_attention`` with
``force_kernel=True`` (the Pallas kernel, interpreted on the CPU),
mirroring tests/test_pallas_paged.py; plus the paged-KV write/gather
ops against their JAX twins.  Inputs are made with numpy from fixed
seeds and fed to both.

Tolerance: f32 on both sides, atol 1e-5 — the kernel accumulates page
by page with an online softmax, the plain version in one pass.  The
CUDA kernel itself is held against the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.ops.paged_kv import gather_paged_kv as jax_gather
from orion_tpu.ops.paged_kv import init_paged_cache as jax_init
from orion_tpu.ops.paged_kv import write_paged_tokens as jax_write
from orion_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as jax_paged_decode)
from orion_tpu_torch.ops.paged_attention import (
    paged_decode_attention, paged_decode_attention_reference)
from orion_tpu_torch.ops.paged_kv import (gather_paged_kv, init_paged_cache,
                                          write_paged_tokens)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _setup(B=3, H=4, Hkv=2, D=16, page_size=8, max_pages=4, seed=0):
    """Random pool (page 0 reserved to exercise padding), per-sequence
    non-contiguous page tables and ragged lengths."""
    rng = np.random.RandomState(seed)
    num_pages = B * max_pages + 1
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(num_pages, Hkv, page_size, D).astype(np.float32)
    vp = rng.randn(num_pages, Hkv, page_size, D).astype(np.float32)
    perm = rng.permutation(num_pages - 1)[:B * max_pages] + 1
    bt = perm.reshape(B, max_pages).astype(np.int32)
    lens = rng.randint(1, page_size * max_pages + 1, B).astype(np.int32)
    return q, kp, vp, bt, lens


def _both(q, kp, vp, bt, lens, scale=0.25):
    expect = np.asarray(jax_paged_decode(
        *(jnp.asarray(x) for x in (q, kp, vp, bt, lens)), scale,
        force_kernel=True))
    got = paged_decode_attention_reference(
        *(torch.from_numpy(x) for x in (q, kp, vp, bt, lens)), scale)
    return got.numpy(), expect


@pytest.mark.parametrize("heads", [(4, 2), (4, 4)], ids=["gqa", "mha"])
def test_plain_matches_jax_kernel(heads):
    H, Hkv = heads
    got, expect = _both(*_setup(H=H, Hkv=Hkv))
    np.testing.assert_allclose(got, expect, rtol=0, atol=ATOL)


def test_single_token_sequences():
    q, kp, vp, bt, _ = _setup(seed=1)
    got, expect = _both(q, kp, vp, bt, np.ones(3, np.int32))
    np.testing.assert_allclose(got, expect, rtol=0, atol=ATOL)


def test_padding_pages_ignored():
    """Table entries past each sequence's last page in use must not
    count, whatever they point at."""
    q, kp, vp, bt, lens = _setup(seed=2)
    got, expect = _both(q, kp, vp, bt, lens)
    ps = kp.shape[2]
    used = (lens + ps - 1) // ps
    bt2 = bt.copy()
    for b in range(bt2.shape[0]):
        bt2[b, used[b]:] = 0
    got2, _ = _both(q, kp, vp, bt2, lens)
    np.testing.assert_array_equal(got2, got)
    np.testing.assert_allclose(got, expect, rtol=0, atol=ATOL)


def test_wrapper_on_cpu_is_plain_and_int8_raises():
    """On the CPU the wrapper is the plain version, for float pools and
    for int8 pools with their scales; a malformed int8 call (scales
    beside float pools, or int8 pools without scales) raises."""
    args = [torch.from_numpy(x) for x in _setup(seed=3)]
    np.testing.assert_array_equal(
        paged_decode_attention(*args, 0.25).numpy(),
        paged_decode_attention_reference(*args, 0.25).numpy())
    q, kp, vp, bt, lens = args
    scales = torch.ones(kp.shape[0], kp.shape[1], 1, kp.shape[2])
    kq, vq = kp.to(torch.int8), vp.to(torch.int8)
    np.testing.assert_array_equal(
        paged_decode_attention(q, kq, vq, bt, lens, 0.25, k_scales=scales,
                               v_scales=scales).numpy(),
        paged_decode_attention_reference(q, kq, vq, bt, lens, 0.25,
                                         k_scales=scales,
                                         v_scales=scales).numpy())
    with pytest.raises(ValueError, match="int8 pools take scales"):
        paged_decode_attention(*args, 0.25, k_scales=scales,
                               v_scales=scales)
    with pytest.raises(ValueError, match="need k_scales"):
        paged_decode_attention(q, kq, vq, bt, lens, 0.25)


def test_write_and_gather_match_jax():
    """Zero-initialised pools, a scatter of new tokens at ragged
    positions, and the slot-ordered gather: bitwise equal to the JAX
    ops (pure copies, no arithmetic)."""
    rng = np.random.RandomState(4)
    B, L, Hkv, D, ps = 2, 5, 2, 8, 4
    jc = jax_init(1, B, 12, Hkv, D, ps, dtype=jnp.float32)[0]
    tc = init_paged_cache(1, B, 12, Hkv, D, ps, dtype=torch.float32,
                          device="cpu")[0]
    assert not tc["k_pages"].any() and not tc["v_pages"].any()
    k = rng.randn(B, L, Hkv, D).astype(np.float32)
    v = rng.randn(B, L, Hkv, D).astype(np.float32)
    pos = np.stack([np.arange(L), 3 + np.arange(L)]).astype(np.int32)
    jc = jax_write(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    write_paged_tokens(tc, torch.from_numpy(k), torch.from_numpy(v),
                       torch.from_numpy(pos))
    np.testing.assert_array_equal(tc["k_pages"].numpy(),
                                  np.asarray(jc["k_pages"]))
    jk, jv = jax_gather(jc, jnp.float32)
    tk, tv = gather_paged_kv(tc)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

