"""The port stands alone: no JAX, and no silent CPU fallback.

* No module of ``horovod_tpu_torch/`` and not ``chip_smoke.py`` imports
  jax, flax, optax or anything of ``horovod_tpu`` (AST scan).
* The port imports and serves with those modules blocked outright.
* Its entry points, given no device on a machine without a card, raise
  instead of quietly running on the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "horovod_tpu_torch"
BANNED = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in BANNED


def test_no_jax_imports_anywhere_in_the_port():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [f"{f.relative_to(ROOT)}: {name}" for f in files
                 for name in _imported_modules(f) if _banned(name)]
    assert not offenders, offenders


def test_port_imports_and_serves_with_jax_blocked():
    code = (
        "import sys\n"
        f"for m in {BANNED!r}: sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "import horovod_tpu_torch\n"
        "from horovod_tpu_torch.models import TransformerConfig, init_params\n"
        "from horovod_tpu_torch.serving import ServingEngine, ServeConfig\n"
        "from horovod_tpu_torch.ops import flash_attention, _build\n"
        "import horovod_tpu_torch.trace, horovod_tpu_torch.metrics\n"
        "cfg = TransformerConfig(vocab_size=50, num_layers=1, num_heads=2,\n"
        "    head_dim=8, max_seq_len=32, dtype=torch.float32)\n"
        "p = init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "eng = ServingEngine(cfg, p, serve=ServeConfig(block_size=4,\n"
        "    decode_tiers=(1, 2)), device='cpu')\n"
        "rid = eng.submit(np.arange(1, 6), max_new_tokens=3)\n"
        "assert len(eng.run()[rid]) == 3\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax', 'optax') or\n"
        "    m == 'horovod_tpu' or m.startswith('horovod_tpu.')\n"
        "    for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from horovod_tpu_torch.common.device import resolve_device
    from horovod_tpu_torch.models import (
        Transformer, TransformerConfig, init_params,
    )
    from horovod_tpu_torch.serving import ServingEngine
    from horovod_tpu_torch.serving.kv_cache import make_pools

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=50, num_layers=1, num_heads=2,
                            head_dim=8, max_seq_len=32, dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pools(1, 2, 4, 2, 8, torch.float32)
    assert Transformer(cfg, params=params).embed.embedding.device.type == "cpu"
    assert make_pools(1, 2, 4, 2, 8, torch.float32,
                      device="cpu")[0].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    """Without a card the smoke script exits non-zero and prints no
    result; alone in a directory (no checkout) it does the same."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    res = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
