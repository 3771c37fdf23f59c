"""Ground rules of the PyTorch/CUDA port (orion_tpu_torch):

- no module of the port, and not chip_smoke.py, imports jax, flax or
  orion_tpu (the port keeps its own copies of what it needs);
- entry points never carry on on the CPU unasked: with no CUDA device
  and no explicit ``device="cpu"`` they raise, a kernel build without
  nvcc raises (every time — a failure is never memoised into a quiet
  fallback), and chip_smoke.py exits non-zero and prints no result;
- kernels A and A′ (``csrc/flash_fwd.cu``) compute both products of
  their bf16 instances with ``wgmma`` on the tensor cores, keep the
  CUDA-core body for f32 only, and call no library kernel.
"""

import ast
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "orion_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "orion_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]


def test_port_imports_nothing_of_jax_or_orion_tpu():
    files = _port_files()
    assert len(files) > 10
    scanned = {os.path.relpath(p, REPO) for p in files}
    assert {f"orion_tpu_torch/{m}.py" for m in (
        "trainers/base", "trainers/grpo", "algos/advantages", "algos/kl",
        "algos/losses", "ops/logprobs", "ops/quant",
        "rollout/engine", "parallel/__init__", "parallel/longctx")} <= scanned
    bad = [f"{os.path.relpath(p, REPO)}:{line} imports {mod}"
           for p in files for line, mod in _imported_roots(p)
           if mod in FORBIDDEN]
    assert bad == []


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_entry_points_raise_without_device(no_cuda):
    from orion_tpu_torch.config import ModelConfig, RolloutConfig
    from orion_tpu_torch.device import resolve_device
    from orion_tpu_torch.models import Transformer
    from orion_tpu_torch.rollout.continuous import ContinuousBatchingEngine

    cfg = ModelConfig.tiny("neox", dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(cfg)
    model = Transformer(cfg, device="cpu")
    rcfg = RolloutConfig(max_prompt_len=8, max_new_tokens=4, page_size=4,
                         max_batch_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(model, cfg, rcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingEngine(model, cfg, rcfg, device="cuda")


def test_trainer_raises_without_device(no_cuda):
    from orion_tpu_torch.config import (GRPOConfig, ModelConfig,
                                        RolloutConfig)
    from orion_tpu_torch.models import Transformer
    from orion_tpu_torch.trainers import GRPOTrainer

    mc = ModelConfig.tiny("neox", dtype="float32")
    cfg = GRPOConfig(model=mc, rollout=RolloutConfig(
        max_prompt_len=8, max_new_tokens=4, page_size=4, max_batch_size=4,
        engine="continuous"), group_size=2, minibatch_size=4)
    model = Transformer(mc, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GRPOTrainer(cfg, model, reward_fn=lambda r, m: 0.0)
    assert GRPOTrainer(cfg, model, device="cpu").device.type == "cpu"


def test_kernel_build_without_nvcc_raises_every_time(no_cuda, monkeypatch,
                                                     tmp_path):
    from orion_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_build.library("paged_decode")


def test_kernel_wrappers_take_plain_version_only_on_cpu():
    """A CPU tensor runs the plain version; any other device type is
    refused rather than computed somewhere else."""
    from orion_tpu_torch.ops.flash_attention import flash_attention_gqa
    from orion_tpu_torch.ops.paged_attention import paged_decode_attention

    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(1, 3, 2, 8).astype(np.float32))
    pos = torch.arange(3, dtype=torch.int32)[None]
    before = flash_attention_gqa.launches
    assert torch.isfinite(flash_attention_gqa(q, q, q, pos, 0.3)).all()
    assert flash_attention_gqa.launches == before  # no kernel on CPU
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_gqa(q.to("meta"), q.to("meta"), q.to("meta"),
                            pos.to("meta"), 0.3)
    with pytest.raises(ValueError, match="unsupported device"):
        paged_decode_attention(q[:, 0].to("meta"), q.to("meta"),
                               q.to("meta"), pos.to("meta"),
                               pos[:, 0].to("meta"), 0.3)


def test_flash_output_carries_the_autograd_function():
    """With inputs that require grad, flash attention's output comes from
    the autograd Function (kernel A forward, kernels B and C backward)
    on every device — here on the CPU through the plain versions, with
    no kernel launched.  Without grad it stays the forward-only call."""
    from orion_tpu_torch.ops.flash_attention import (flash_attention_gqa,
                                                     flash_bwd_dkv,
                                                     flash_bwd_dq)

    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(1, 4, 2, 8).astype(np.float32))
    pos = torch.arange(4, dtype=torch.int32)[None]
    counts = (flash_attention_gqa.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    leaf = q.clone().requires_grad_()
    out = flash_attention_gqa(leaf, q, q, pos, 0.3)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.sum().backward()
    assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
    with torch.no_grad():
        assert flash_attention_gqa(leaf, q, q, pos, 0.3).grad_fn is None
    assert flash_attention_gqa(q, q, q, pos, 0.3).grad_fn is None
    assert (flash_attention_gqa.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == counts
    lse = torch.zeros(1, 2, 4)
    for fn in (flash_bwd_dq, flash_bwd_dkv):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*(t.to("meta") for t in (q, q, q, pos, q, lse, lse)), 0.3)


def test_chunk_wrappers_take_plain_version_only_on_cpu():
    """Kernels A′, B′ and C′'s wrappers: CPU tensors run the plain
    versions and launch nothing; any other device type is refused."""
    from orion_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(2)
    q = torch.from_numpy(rng.randn(1, 4, 2, 8).astype(np.float32))
    qpos = torch.arange(4, dtype=torch.int32)[None]
    kvpos = qpos.flip(1) + 1
    kernels = (fa.flash_chunk_fwd, fa.flash_chunk_bwd_dq,
               fa.flash_chunk_bwd_dkv)
    counts = [fn.launches for fn in kernels]
    out, lse = fa.flash_chunk_fwd(q, q, q, qpos, kvpos, 0.3)
    assert (out[0, 0] == 0).all() and (lse[0, :, 0] < -1e29).all()
    grads = fa.flash_chunk_grads(q, q, q, qpos, kvpos, out, lse, q, 0.3)
    assert all(torch.isfinite(g).all() for g in grads)
    assert [fn.launches for fn in kernels] == counts
    meta = [t.to("meta") for t in (q, qpos, kvpos, lse)]
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_chunk_fwd(meta[0], meta[0], meta[0], meta[1], meta[2], 0.3)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_chunk_grads(meta[0], meta[0], meta[0], meta[1], meta[2],
                             meta[0], meta[3], meta[0], 0.3)


def test_ring_needs_a_device_and_an_active_ring(no_cuda):
    """The ring model and ring attention never carry on on the CPU
    unasked, and attention(impl="ring" | "ulysses") raises outside a
    sequence_parallel block (or without positions)."""
    from orion_tpu_torch.config import ModelConfig
    from orion_tpu_torch.models import Transformer
    from orion_tpu_torch.ops.attention import attention
    from orion_tpu_torch.parallel import (StackedRing, ring_attention,
                                          sequence_parallel)
    from orion_tpu_torch.parallel.longctx import active_ring

    cfg = ModelConfig.tiny("neox", dtype="float32", attention_impl="ring")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(cfg)
    q = torch.zeros(4, 2, 2, 8, device="meta")
    pos = torch.zeros(4, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ring_attention(q, q, q, pos, pos, 0.3, StackedRing(4))
    q = torch.zeros(4, 2, 2, 8)
    pos = torch.zeros(4, 2, dtype=torch.int32)
    for impl in ("ring", "ulysses"):
        with pytest.raises(RuntimeError, match="needs an active ring"):
            attention(q, q, q, None, 0.3, impl=impl, q_positions=pos)
        with sequence_parallel(StackedRing(2)):
            with pytest.raises(ValueError, match="requires q_positions"):
                attention(q, q, q, None, 0.3, impl=impl)
    outer, inner = StackedRing(2), StackedRing(4)
    with sequence_parallel(outer):
        with sequence_parallel(inner):
            assert active_ring("ring") is inner
        assert active_ring("ring") is outer
    with pytest.raises(RuntimeError, match="needs an active ring"):
        active_ring("ring")


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_card(no_cuda, tmp_path):
    res = _run_smoke(REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    res = _run_smoke(alone)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _function_body(src, signature):
    """The text of the brace-delimited body that follows ``signature``."""
    start = src.index("{", src.index(signature))
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1]
    raise AssertionError(f"unbalanced braces after {signature}")


def test_flash_fwd_bf16_runs_both_products_on_wgmma():
    with open(os.path.join(REPO, "orion_tpu_torch", "csrc", "flash_fwd.cu"),
              encoding="utf-8") as f:
        src = f.read()
    code = re.sub(r"//[^\n]*", "", src)       # comments may name anything
    # S = Q·Kᵀ and O += P·V: each wrapper issues wgmma.mma_async, S with
    # both operands in shared memory, P·V with P from registers at
    # N = D for every head dim.
    ss = _function_body(code, "void wgmma_ss_n64(")
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in ss
    for n in (64, 128, 256):
        rs = _function_body(code, f"void wgmma_rs_n{n}(")
        assert (f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16"
                in rs)
        assert '"r"(a[0])' in rs           # the A operand from registers
    pv = _function_body(code, "void wgmma_pv(")
    assert all(f"wgmma_rs_n{n}(" in pv for n in (64, 128, 256))
    body = _function_body(code, "flash_fwd_wgmma_kernel(FlashParams p)")
    assert "wgmma_ss_n64(" in body and "wgmma_pv<D>(" in body
    assert "cp_async16(" in body and "fence_proxy_async()" in body
    # The f32 body stays on the CUDA cores; dtype 1 (bf16) reaches only
    # the wgmma launch, dtype 0 (f32) only the CUDA-core one.
    f32 = _function_body(code, "flash_fwd_kernel(FlashParams p)")
    assert "wgmma" not in f32
    dispatch = _function_body(code, "int dispatch(")
    f32_branch, bf16_branch = dispatch.split("dtype == 1")
    assert "launch_f32" in f32_branch and "launch_wgmma" not in f32_branch
    assert "launch_wgmma" in bf16_branch and "launch_f32" not in bf16_branch
    # No library kernel: only the port's own header and the C headers.
    assert set(re.findall(r'#include\s+[<"]([^>"]+)[>"]', src)) == {
        "climits", "common.cuh"}
    assert not re.search(r"cublas|cudnn|cutlass|cute::|thrust|cub::|at::|"
                         r"torch|flash_attn", code, re.IGNORECASE)
