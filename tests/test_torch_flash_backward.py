"""The backward of the PyTorch/CUDA port's flash attention (kernels B
and C's plain version, and the autograd Function that joins them to
kernel A) against ``jax.vjp`` of the JAX package's
``flash_attention_gqa``, whose custom VJP runs the Pallas ``_dq_kernel``
and ``_dkv_kernel`` in interpret mode on the CPU.  Inputs and the
cotangent dO are made with numpy from fixed seeds and fed to both.

Tolerances: f32 on both sides, atol 1e-4 — the JAX package's own
tolerance for its backward (tests/test_pallas_flash.py); the Pallas
kernels block the kv and q axes, the plain version sums in one pass.
The Function on the CPU runs the plain version, so its gradients equal
``flash_attention_backward_reference`` exactly; ``gradcheck`` holds the
whole Function to finite differences at float64.  The CUDA kernels
themselves are held against the plain version on the card in
tests/test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orion_tpu.ops.pallas.flash_attention import (
    flash_attention_gqa as jax_flash_attention_gqa)
from orion_tpu_torch.ops.flash_attention import (
    FlashAttention, flash_attention_backward_reference, flash_attention_gqa,
    flash_attention_reference)

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(B, Lq, Lk, H, Hkv, D, seed, offsets):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Lq, H, D).astype(np.float32)
    k = rng.randn(B, Lk, Hkv, D).astype(np.float32)
    v = rng.randn(B, Lk, Hkv, D).astype(np.float32)
    dout = rng.randn(B, Lq, H, D).astype(np.float32)
    if offsets is None:
        offsets = rng.randint(0, Lk - Lq + 1, B)
    pos = (np.asarray(offsets)[:, None]
           + np.arange(Lq)[None, :]).astype(np.int32)
    return q, k, v, dout, pos


CASES = [
    # name, (B, Lq, Lk, H, Hkv, D), offsets (None = random per row)
    ("causal", (1, 16, 16, 4, 2, 8), [0]),
    ("ragged_5_vs_24", (3, 5, 24, 2, 1, 16), None),
    ("odd_13", (2, 13, 13, 2, 2, 8), [0, 0]),
    ("row_without_keys", (2, 6, 10, 2, 1, 8), [-1, 3]),
]


@pytest.mark.parametrize("name,shape,offsets", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_backward_matches_jax_vjp(name, shape, offsets):
    B, Lq, Lk, H, Hkv, D = shape
    q, k, v, dout, pos = _inputs(*shape, seed=len(name), offsets=offsets)
    scale = 1.0 / D ** 0.5
    _, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash_attention_gqa(
            q_, k_, v_, jnp.asarray(pos), scale),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    expect = [np.asarray(g) for g in vjp(jnp.asarray(dout))]

    tq, tk, tv, tdo, tp = (torch.from_numpy(x)
                           for x in (q, k, v, dout, pos))
    out, lse = flash_attention_reference(tq, tk, tv, tp, scale,
                                         return_lse=True)
    got = flash_attention_backward_reference(tq, tk, tv, tp, out, lse, tdo,
                                             scale)
    for g, e, which in zip(got, expect, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), e, rtol=0, atol=ATOL,
                                   err_msg=which)
    if offsets is not None and offsets[0] < 0:
        # The row whose position precedes every slot: no gradient.
        np.testing.assert_array_equal(got[0][0, 0].numpy(), 0.0)


def test_function_grad_equals_plain_backward():
    """torch.autograd.grad through the Function (the training path's
    route) gives the plain backward's numbers exactly."""
    q, k, v, dout, pos = _inputs(2, 9, 12, 4, 2, 8, seed=7, offsets=None)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_()
                  for x in (q, k, v))
    tdo, tp = torch.from_numpy(dout), torch.from_numpy(pos)
    out = flash_attention_gqa(tq, tk, tv, tp, 0.3)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, (tq, tk, tv), tdo)
    with torch.no_grad():
        ref_out, lse = flash_attention_reference(tq, tk, tv, tp, 0.3,
                                                 return_lse=True)
        expect = flash_attention_backward_reference(tq, tk, tv, tp, ref_out,
                                                    lse, tdo, 0.3)
    np.testing.assert_array_equal(out.detach().numpy(), ref_out.numpy())
    for g, e in zip(got, expect):
        np.testing.assert_array_equal(g.numpy(), e.numpy())


def test_function_passes_gradcheck():
    """Finite differences at float64 (B=1, L=6, H=2 over one kv head,
    D=4; the first query's position is -1, so one row has no key)."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(*s)).requires_grad_()
               for s in ((1, 6, 2, 4), (1, 6, 1, 4), (1, 6, 1, 4)))
    pos = torch.arange(6, dtype=torch.int32)[None] - 1
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: FlashAttention.apply(q_, k_, v_, pos, 0.5)[0],
        (q, k, v), eps=1e-6, atol=1e-5)
