"""Sequence parallelism of the PyTorch/CUDA port (ring attention, its
zigzag layout and Ulysses, ``orion_tpu_torch.parallel.longctx``) and the
plain versions of kernels A′, B′ and C′, against the JAX package on the
CPU.  Inputs, weights and cotangents are made with numpy from fixed
seeds and fed to both.

- A′ and B′/C′: the port's ``flash_chunk_fwd_reference`` /
  ``flash_chunk_grads_reference`` against the JAX ``flash_chunk_fwd`` /
  ``flash_chunk_grads``, whose Pallas kernels run in interpret mode.
  The JAX forward gives the mean of V on a row with no valid key when
  another row of its q tile has one (its masked scores are a finite
  -1e30); the port gives 0.  So O is compared on rows with a valid key
  only; on the others the port's O is 0 and both LSEs are <= -1e29,
  and the ring merge gives either weight 0.
- The ring: the port's ``ring_attention`` on a ``StackedRing(4)``
  against the JAX ``ring_attention`` under ``shard_map`` on 4 of the 8
  CPU devices, outputs and the gradients of q, k and v; and against the
  port's dense-per-chunk ``ring_attention_reference``.
- The slice as a whole: tiny neox and llama (GQA) models with weights
  carried across by ``load_jax_params``, run sequence parallel over a
  ring of 4 in zigzag layout, against the JAX dense model.

Tolerances: f32 on both sides.  Chunk math and the ring against JAX
atol 1e-4 (the JAX package's own for its flash kernels); the port's
ring against its own dense-per-chunk ring 2e-5 (the same merge, the
sums in another order); model logits, loss and gradients rtol/atol
2e-4 (the JAX package's ring-vs-dense tolerance); the AdamW step 2e-4
on entries whose gradient exceeds 1e-4 — Adam's first step is
lr·sign(g), which may flip between frameworks where |g| is near 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from orion_tpu.config import MeshConfig
from orion_tpu.config import ModelConfig as JaxModelConfig
from orion_tpu.models import Transformer as JaxTransformer
from orion_tpu.models import init_params
from orion_tpu.ops.pallas.flash_attention import (
    flash_chunk_fwd as jax_chunk_fwd)
from orion_tpu.ops.pallas.flash_attention import (
    flash_chunk_grads as jax_chunk_grads)
from orion_tpu.parallel.longctx import ring_attention as jax_ring_attention
from orion_tpu.parallel.longctx import (
    ulysses_attention as jax_ulysses_attention)
from orion_tpu.parallel.longctx import zigzag_inverse as jax_zigzag_inverse
from orion_tpu.parallel.longctx import zigzag_order as jax_zigzag_order
from orion_tpu.parallel.mesh import make_mesh
from orion_tpu.utils.platform import shard_map
from orion_tpu_torch.config import ModelConfig, OptimizerConfig
from orion_tpu_torch.models.convert import load_jax_params
from orion_tpu_torch.ops.flash_attention import (flash_chunk_fwd_reference,
                                                 flash_chunk_grads_reference)
from orion_tpu_torch.parallel import (StackedRing, ring_attention,
                                      ring_attention_reference,
                                      sequence_parallel, ulysses_attention,
                                      zigzag_inverse, zigzag_order)
from orion_tpu_torch.smoke import longctx_loss
from orion_tpu_torch.trainers.base import make_optimizer

ATOL = 1e-4
SELF_ATOL = 2e-5
MODEL_TOL = 2e-4
S = 4  # ring size


@pytest.fixture(autouse=True)
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _rank_positions(L, s, rank, rotations):
    """(q positions, kv positions) of ``rank`` in the zigzag layout of a
    length-L sequence over s ranks, its kv after ``rotations`` ring
    steps (it then holds rank - rotations' keys)."""
    per = zigzag_order(L, s).reshape(s, L // s)
    return per[rank], per[(rank - rotations) % s]


def _chunk_case(name):
    """q/k/v [B, Lq|Lk, H|Hkv, D] and q/kv positions [B, Lq|Lk] int32."""
    rng = np.random.RandomState(len(name))
    H, Hkv, D = 2, 2, 16
    if name == "contiguous":
        qpos = np.stack([np.arange(16) + 8, np.arange(16)])
        kvpos = np.stack([np.arange(24)] * 2)
    elif name == "zigzag_rotated":
        # Rank 0 (q chunks 0 and 7) against rank 3's keys (chunks 3 and
        # 4): the first 8 rows see no key.  Rank 2 against rank 1's.
        rows = [_rank_positions(64, S, r, 1) for r in (0, 2)]
        qpos, kvpos = (np.stack(x) for x in zip(*rows))
    elif name == "all_future":
        qpos = np.stack([np.arange(16)] * 2)
        kvpos = qpos + 1000
    elif name == "gqa":
        H, Hkv = 4, 2
        rows = [_rank_positions(64, S, r, 1) for r in (1, 3)]
        qpos, kvpos = (np.stack(x) for x in zip(*rows))
    elif name == "odd_unordered":  # odd lengths, keys in no order
        qpos = np.stack([rng.permutation(20)[:13] for _ in range(2)])
        kvpos = np.stack([rng.randint(0, 24, 11) for _ in range(2)])
    # Tile edges of the card kernel A′ (64-row warpgroup tiles, 128-row
    # q tiles, 64-slot kv tiles).
    elif name == "len_1":
        qpos, kvpos = np.array([[0], [5]]), np.array([[0], [3]])
    elif name == "len_63_vs_65":
        qpos = np.stack([rng.permutation(200)[:63] for _ in range(2)])
        kvpos = np.stack([rng.permutation(200)[:65] for _ in range(2)])
    elif name == "len_64_gqa4":
        H, Hkv = 4, 1
        rows = [_rank_positions(128, 2, r, 1) for r in (0, 1)]
        qpos, kvpos = (np.stack(x) for x in zip(*rows))
    elif name == "len_129":
        qpos = np.stack([np.arange(129) + 64, np.arange(129)])
        kvpos = np.stack([np.arange(129)] * 2)
    elif name == "visible_beside_straddling":
        # Slots 0..127 visible to every query, the rest straddle; row 1
        # holds the same keys in no order.
        qpos = np.stack([np.arange(64) + 136] * 2)
        kvpos = np.stack([np.arange(200), rng.permutation(200)])
    else:  # "zigzag_tile_edges": 130-token chunks after one rotation
        rows = [_rank_positions(520, S, r, 1) for r in (0, 2)]
        qpos, kvpos = (np.stack(x) for x in zip(*rows))
    B, Lq, Lk = qpos.shape[0], qpos.shape[1], kvpos.shape[1]
    q = rng.randn(B, Lq, H, D).astype(np.float32)
    k = rng.randn(B, Lk, Hkv, D).astype(np.float32)
    v = rng.randn(B, Lk, Hkv, D).astype(np.float32)
    return q, k, v, qpos.astype(np.int32), kvpos.astype(np.int32)


CHUNK_CASES = ["contiguous", "zigzag_rotated", "all_future", "gqa",
               "odd_unordered", "len_1", "len_63_vs_65", "len_64_gqa4",
               "len_129", "visible_beside_straddling", "zigzag_tile_edges"]


@pytest.mark.parametrize("name", CHUNK_CASES)
def test_chunk_fwd_plain_matches_jax(name):
    q, k, v, qpos, kvpos = _chunk_case(name)
    scale = 1.0 / q.shape[-1] ** 0.5
    j_out, j_lse = (np.asarray(x) for x in jax_chunk_fwd(
        *(jnp.asarray(x) for x in (q, k, v, qpos, kvpos)), scale))
    out, lse = flash_chunk_fwd_reference(*_t(q, k, v, qpos, kvpos), scale)
    out, lse = out.numpy(), lse.numpy()
    has_key = (kvpos[:, None, :] <= qpos[:, :, None]).any(-1)   # [B, Lq]
    if name in ("zigzag_rotated", "all_future", "len_64_gqa4",
                "zigzag_tile_edges"):
        assert not has_key.all()
    np.testing.assert_allclose(out[has_key], j_out[has_key], rtol=0,
                               atol=ATOL)
    lse_rows, j_lse_rows = lse.transpose(0, 2, 1), j_lse.transpose(0, 2, 1)
    np.testing.assert_allclose(lse_rows[has_key], j_lse_rows[has_key],
                               rtol=0, atol=ATOL)
    np.testing.assert_array_equal(out[~has_key], 0.0)
    assert (lse_rows[~has_key] <= -1e29).all()
    assert (j_lse_rows[~has_key] <= -1e29).all()


@pytest.mark.parametrize("name", ["zigzag", "gqa"])
def test_chunk_grads_plain_match_jax(name):
    """Each of two chunks' (dq, dk, dv) against the JAX
    flash_chunk_grads, both given the global LSE, merged O and dO of
    the two chunks together; the chunks' dq add up to the whole
    backward's and their dk/dv are its pieces."""
    rng = np.random.RandomState(11 + len(name))
    H, Hkv = (2, 2) if name == "zigzag" else (4, 2)
    B, D, L = 2, 16, 64
    qpos = np.stack([_rank_positions(L, S, r, 0)[0] for r in (0, 3)])
    # The keys in zigzag order over 2 halves: each half holds two
    # separate runs of positions.
    kv_all = np.stack([zigzag_order(L, 2)] * B).astype(np.int32)
    q = rng.randn(B, qpos.shape[1], H, D).astype(np.float32)
    k = rng.randn(B, L, Hkv, D).astype(np.float32)
    v = rng.randn(B, L, Hkv, D).astype(np.float32)
    dout = rng.randn(*q.shape).astype(np.float32)
    scale = 1.0 / D ** 0.5
    tq, tk, tv, tqp, tkvp, tdo = _t(q, k, v, qpos.astype(np.int32), kv_all,
                                    dout)
    out, lse = flash_chunk_fwd_reference(tq, tk, tv, tqp, tkvp, scale)
    whole = flash_chunk_grads_reference(tq, tk, tv, tqp, tkvp, out, lse,
                                        tdo, scale)
    halves = (slice(0, L // 2), slice(L // 2, L))
    dq_sum = torch.zeros_like(tq)
    for part in halves:
        kk, vv, kvp = tk[:, part], tv[:, part], tkvp[:, part]
        got = flash_chunk_grads_reference(tq, kk, vv, tqp, kvp, out, lse,
                                          tdo, scale)
        expect = jax_chunk_grads(*(jnp.asarray(x.numpy()) for x in (
            tq, kk, vv, tqp, kvp, out, lse, tdo)), scale)
        for g, e, which in zip(got, expect, ("dq", "dk", "dv")):
            np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=0,
                                       atol=ATOL, err_msg=which)
        dq_sum += got[0]
        np.testing.assert_allclose(got[1].numpy(), whole[1][:, part].numpy(),
                                   rtol=0, atol=SELF_ATOL)
        np.testing.assert_allclose(got[2].numpy(), whole[2][:, part].numpy(),
                                   rtol=0, atol=SELF_ATOL)
    np.testing.assert_allclose(dq_sum.numpy(), whole[0].numpy(), rtol=0,
                               atol=SELF_ATOL)


def _seq_mesh():
    return make_mesh(MeshConfig(data=1, fsdp=1, seq=S, tensor=1),
                     jax.devices()[:S])


def _sharded(fn, n_in):
    return shard_map(fn, mesh=_seq_mesh(),
                     in_specs=tuple(P(None, "seq") for _ in range(n_in)),
                     out_specs=P(None, "seq"), check_vma=False)


def _ring_inputs(B=2, L=32, H=4, Hkv=2, D=16, seed=3):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, L, H, D).astype(np.float32)
    k = rng.randn(B, L, Hkv, D).astype(np.float32)
    v = rng.randn(B, L, Hkv, D).astype(np.float32)
    dout = rng.randn(B, L, H, D).astype(np.float32)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    return q, k, v, dout, pos


@pytest.fixture(scope="module")
def jax_ring():
    """The JAX ring under shard_map, zigzag layout: its output and the
    gradients of sum(out * dout) in natural token order (one
    jax.value_and_grad)."""
    q, k, v, dout, pos = _ring_inputs()
    L = q.shape[1]
    order, inv = jax_zigzag_order(L, S), jax_zigzag_inverse(L, S)
    ring = _sharded(lambda *a: jax_ring_attention(*a, 0.25), 5)
    dz = jnp.asarray(dout[:, order])
    pz = jnp.asarray(pos[:, order])

    def loss(q_, k_, v_):
        out = ring(q_, k_, v_, pz, pz)
        return jnp.sum(out * dz), out

    with _seq_mesh():
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(x[:, order]) for x in (q, k, v)))
    return [np.asarray(x)[:, inv] for x in (out, *grads)]


def _port_ring(fn):
    """``fn`` (ring_attention or its reference) on a StackedRing(S) over
    the same inputs: output and q/k/v gradients, natural order."""
    q, k, v, dout, pos = _ring_inputs()
    ring = StackedRing(S)
    tq, tk, tv = (ring.shard(x).requires_grad_()
                  for x in _t(q, k, v))
    tpos = ring.shard(torch.from_numpy(pos))
    out = fn(tq, tk, tv, tpos, tpos, 0.25, ring)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                ring.shard(torch.from_numpy(dout)))
    return [ring.unshard(x).detach().numpy() for x in (out, *grads)]


def test_ring_matches_jax_shard_map_ring(jax_ring):
    got = _port_ring(ring_attention)
    for g, e, which in zip(got, jax_ring, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, e, rtol=0, atol=ATOL, err_msg=which)


def test_ring_matches_dense_per_chunk_ring():
    """Output against the port's ring_attention_reference, and the
    gradients of the ring's own backward (chunk grads against the
    global LSE, dk/dv travelling home) against autograd through it."""
    got = _port_ring(ring_attention)
    expect = _port_ring(ring_attention_reference)
    for g, e, which in zip(got, expect, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, e, rtol=0, atol=SELF_ATOL,
                                   err_msg=which)


def test_ulysses_matches_jax_ulysses():
    """Contiguous layout, 8 heads over 4 kv heads on a ring of 4."""
    q, k, v, _, pos = _ring_inputs(H=8, Hkv=4, seed=5)
    fn = _sharded(lambda *a: jax_ulysses_attention(*a, 0.25), 4)
    with _seq_mesh():
        expect = np.asarray(jax.jit(fn)(*(jnp.asarray(x)
                                          for x in (q, k, v, pos))))
    ring = StackedRing(S)
    out = ulysses_attention(*(ring.shard(x, zigzag=False)
                              for x in _t(q, k, v, pos)), 0.25, ring)
    np.testing.assert_allclose(ring.unshard(out, zigzag=False).numpy(),
                               expect, rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="ulysses needs"):
        ulysses_attention(*(StackedRing(8).shard(x, zigzag=False)
                            for x in _t(q, k, v, pos)), 0.25,
                          StackedRing(8))


@pytest.mark.parametrize("L,s", [(16, 2), (64, 4), (48, 3)])
def test_zigzag_layout_matches_jax(L, s):
    np.testing.assert_array_equal(zigzag_order(L, s), jax_zigzag_order(L, s))
    np.testing.assert_array_equal(zigzag_inverse(L, s),
                                  jax_zigzag_inverse(L, s))
    ring = StackedRing(s)
    x = torch.arange(2 * L).reshape(2, L) * 10
    sharded = ring.shard(x)
    c = L // (2 * s)
    for d in range(s):   # rank d holds chunks (d, 2s-1-d) of each row
        expect = np.concatenate([np.arange(d * c, (d + 1) * c),
                                 np.arange((2 * s - 1 - d) * c,
                                           (2 * s - d) * c)])
        for b in range(2):
            np.testing.assert_array_equal(sharded[d * 2 + b].numpy(),
                                          x[b, expect].numpy())
    np.testing.assert_array_equal(ring.unshard(sharded).numpy(), x.numpy())
    rotated = ring.rotate(sharded)
    np.testing.assert_array_equal(rotated.numpy(),
                                  torch.roll(sharded, 2, dims=0).numpy())


# -- the slice as a whole: tiny models, sequence parallel over a ring ------

ARCHS = {
    "neox": dict(rotary_pct=0.25, use_parallel_residual=True,
                 attn_bias=True, mlp_bias=True),
    "llama": dict(),   # GQA: 4 query heads over 2 kv heads
}
LR = 1e-3


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model_case(request):
    """One weight set in both packages (the init perturbed by numpy, so
    the bias and norm crossings count), a batch of 2 x 64 ids with the
    next id as target, and the JAX dense model's logits, loss,
    gradients and one optax AdamW step."""
    arch = request.param
    jcfg = JaxModelConfig.tiny(arch, dtype="float32",
                               attention_impl="reference", **ARCHS[arch])
    jmodel = JaxTransformer(jcfg)
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda key: init_params(jmodel, key, jcfg))(jax.random.key(0)))
    rng = np.random.RandomState(1)
    tree = jax.tree.map(
        lambda x: (x + 0.05 * rng.randn(*x.shape)).astype(np.float32), tree)
    seq = rng.randint(1, jcfg.vocab_size, (2, 65))
    ids, tgt = seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)
    pos = np.broadcast_to(np.arange(64, dtype=np.int32), ids.shape)

    def loss(params):
        logits, _ = jmodel.apply({"params": params}, jnp.asarray(ids),
                                 jnp.asarray(pos))
        lp = jax.nn.log_softmax(logits, axis=-1)
        ce = -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(tgt)[..., None],
                                           axis=-1))
        return ce, logits

    params = jax.tree.map(jnp.asarray, tree)
    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    tx = optax.adamw(LR, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0)
    stepped = jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(jgrads, params)
    cfg = ModelConfig.tiny(arch, dtype="float32", attention_impl="ring",
                           **ARCHS[arch])
    as_port = lambda t: dict(load_jax_params(  # noqa: E731
        jax.tree.map(np.asarray, t), cfg, device="cpu").named_parameters())
    return {"cfg": cfg, "tree": tree, "ids": ids, "tgt": tgt,
            "loss": float(jloss), "logits": np.asarray(jlogits),
            "grads": as_port(jgrads), "stepped": as_port(stepped)}


def test_ring_model_logits_match_jax_dense(model_case):
    c = model_case
    model = load_jax_params(c["tree"], c["cfg"], device="cpu")
    ring = StackedRing(S)
    ids = torch.from_numpy(c["ids"]).long()
    pos = torch.arange(64)[None].expand(2, 64)
    with torch.no_grad(), sequence_parallel(ring):
        logits = model(ring.shard(ids), ring.shard(pos))
    np.testing.assert_allclose(ring.unshard(logits).numpy(), c["logits"],
                               rtol=MODEL_TOL, atol=MODEL_TOL)


def test_ring_model_grads_and_adamw_step_match_jax_dense(model_case):
    """The smoke mix's loss (``longctx_loss``) on the ring model: loss
    and every parameter's gradient against jax.value_and_grad of the
    dense model, then one AdamW step (the trainer's optimizer) against
    optax's adamw."""
    c = model_case
    model = load_jax_params(c["tree"], c["cfg"], device="cpu")
    ids, tgt = (torch.from_numpy(x).long() for x in (c["ids"], c["tgt"]))
    loss = longctx_loss(model, ids, tgt, StackedRing(S))
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    assert abs(loss.item() - c["loss"]) <= MODEL_TOL
    assert sorted(grads) == sorted(c["grads"])
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), c["grads"][n].detach().numpy(),
                                   rtol=MODEL_TOL, atol=MODEL_TOL, err_msg=n)
    opt = make_optimizer(dataclasses.replace(
        OptimizerConfig(), learning_rate=LR, weight_decay=0.0),
        params.values())
    for n, p in params.items():
        p.grad = grads[n]
    opt.step()
    for n, p in params.items():
        jg = c["grads"][n].detach().numpy()
        live = np.abs(jg) > 1e-4
        assert live.any(), n
        np.testing.assert_allclose(
            p.detach().numpy()[live],
            c["stepped"][n].detach().numpy()[live], rtol=0, atol=MODEL_TOL,
            err_msg=n)
