"""Ground rules of the PyTorch/CUDA port (orion_tpu_torch):

- no module of the port, and not chip_smoke.py, imports jax, flax or
  orion_tpu (the port keeps its own copies of what it needs);
- entry points never carry on on the CPU unasked: with no CUDA device
  and no explicit ``device="cpu"`` they raise, a kernel build without
  nvcc raises (every time — a failure is never memoised into a quiet
  fallback), and chip_smoke.py exits non-zero and prints no result.
"""

import ast
import os
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
        "algos/losses", "ops/logprobs", "rollout/engine")} <= scanned
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
