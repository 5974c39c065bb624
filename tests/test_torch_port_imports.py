"""The port stands alone: no JAX, and no silent CPU fallback.

* No module of ``horovod_tpu_torch/`` and not ``chip_smoke.py`` imports
  jax, flax, optax or anything of ``horovod_tpu`` (AST scan); the
  contract checker (``horovod_tpu_torch.analysis``) imports the standard
  library only (its gated ``programs`` pass, the runtime inside its
  functions), and runs with torch and the port's runtime blocked.
* The TensorFlow and Keras adapters are imported by name only: the
  package and its checker import neither TensorFlow nor Keras.
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
    """Every module imports, the engine serves (plain, speculative, and
    through a prefill→decode fleet), training steps run (the
    transformer's and the ResNet's), ring attention runs (world 1), the
    guard, elastic and runner modules import and one guarded step runs,
    and the bench, timeline, profiler bridge, cluster snapshot and step
    inventories import and run, and the rest of ``parallel/`` (the
    Megatron layers, tensor-sharded serving's set, Ulysses, MoE, the
    pipeline and the dp × sp × tp trainer) imports and runs at world 1,
    and the two-level collectives' modules import and hierarchical ZeRO
    steps at world 1 (one slice: the flat exchange), with jax, flax,
    optax and horovod_tpu blocked outright."""
    code = (
        "import sys\n"
        f"for m in {BANNED!r}: sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "import horovod_tpu_torch\n"
        "from horovod_tpu_torch.models import TransformerConfig, init_params\n"
        "from horovod_tpu_torch.serving import ServingEngine, ServeConfig\n"
        "from horovod_tpu_torch.ops import flash_attention, _build\n"
        "import horovod_tpu_torch.trace, horovod_tpu_torch.metrics\n"
        "import horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch import training, optim, functions\n"
        "from horovod_tpu_torch.common import basics, exceptions\n"
        "from horovod_tpu_torch.ops import (collective_ops, fusion,\n"
        "    reduce_ops)\n"
        "from horovod_tpu_torch.models import Transformer, gpt_small\n"
        "from horovod_tpu_torch.models import params_to_numpy_tree\n"
        "from horovod_tpu_torch.ops import fused_norm\n"
        "from horovod_tpu_torch.models import (ResNetTiny, MLP, LeNet,\n"
        "    resnet_params_to_flax)\n"
        "from horovod_tpu_torch import sync_batch_norm\n"
        "cfg = TransformerConfig(vocab_size=50, num_layers=1, num_heads=2,\n"
        "    head_dim=8, max_seq_len=32, dtype=torch.float32)\n"
        "p = init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "eng = ServingEngine(cfg, p, serve=ServeConfig(block_size=4,\n"
        "    decode_tiers=(1, 2)), device='cpu')\n"
        "rid = eng.submit(np.arange(1, 6), max_new_tokens=3)\n"
        "assert len(eng.run()[rid]) == 3\n"
        "hvd.init(device='cpu')\n"
        "tc = gpt_small(vocab_size=50, num_layers=1, max_seq_len=32,\n"
        "    dtype=torch.float32, attention_impl='flash')\n"
        "m = Transformer(tc, params=init_params(tc,\n"
        "    torch.Generator().manual_seed(0), 'cpu'))\n"
        "opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(),\n"
        "    lr=0.1))\n"
        "toks = torch.randint(0, 50, (2, 9))\n"
        "training.softmax_cross_entropy(m(toks[:, :-1]), toks[:, 1:])\\\n"
        "    .backward()\n"
        "opt.step()\n"
        "rn = ResNetTiny(dtype=torch.float32, device='cpu')\n"
        "ro = torch.optim.SGD(rn.parameters(), lr=0.1, momentum=0.9)\n"
        "rstep = training.data_parallel_train_step(rn, ro)\n"
        "_, rl = rstep(training.create_train_state(rn, ro),\n"
        "    torch.randn(2, 16, 16, 3), torch.tensor([1, 2]))\n"
        "assert bool(torch.isfinite(rl))\n"
        "import tempfile\n"
        "from horovod_tpu_torch import callbacks, chaos, checkpoint, data\n"
        "rr = ResNetTiny(dtype=torch.float32, device='cpu', remat=True)\n"
        "rq = torch.optim.SGD(rr.parameters(), lr=0.1)\n"
        "src = data.ArraySource(np.random.randn(8, 16, 16, 3).astype(\n"
        "    np.float32), np.arange(8) % 10)\n"
        "ld = data.DataLoader(src, batch_size=4, device='cpu')\n"
        "d = tempfile.mkdtemp()\n"
        "st, fl = training.fit_epoch(training.data_parallel_train_step(rr,\n"
        "    rq), training.create_train_state(rr, rq), ld, epoch=0,\n"
        "    checkpoint_dir=d, checkpoint_every=1)\n"
        "assert st.step == 2 and checkpoint.latest_checkpoint(d)\n"
        "assert checkpoint.restore_checkpoint(d, st).step == 2\n"
        "hvd.shutdown()\n"
        "from horovod_tpu_torch import fleet\n"
        "from horovod_tpu_torch.fleet import FleetRouter, ServingReplica\n"
        "from horovod_tpu_torch.serving import speculative\n"
        "from horovod_tpu_torch.metrics import exposition\n"
        "from horovod_tpu_torch.trace import export, flight\n"
        "from horovod_tpu_torch.ops import comm_model\n"
        "se = ServingEngine(cfg, p, serve=ServeConfig(block_size=4,\n"
        "    decode_tiers=(1, 2), spec=True), device='cpu')\n"
        "sr = se.submit(np.array([3, 4, 3, 4, 3, 4, 3]), max_new_tokens=6)\n"
        "er = eng.submit(np.array([3, 4, 3, 4, 3, 4, 3]), max_new_tokens=6)\n"
        "assert (se.run()[sr] == eng.run()[er]).all()\n"
        "assert se.spec_steps > 0\n"
        "mk = lambda role='both': ServingEngine(cfg, p, serve=ServeConfig(\n"
        "    block_size=4, decode_tiers=(1, 2)), device='cpu', role=role)\n"
        "fr = FleetRouter(mk, replicas=1, prefill_replicas=1)\n"
        "g = fr.submit(np.arange(1, 10), 4)\n"
        "assert len(fr.run_until_drained()[g]) == 4\n"
        "assert fr.handoffs['warm'] == 1\n"
        "from horovod_tpu_torch.parallel import (ring_attention,\n"
        "    ring_flash_attention, ring_window_steps)\n"
        "hvd.init(device='cpu')\n"
        "rq = torch.randn(1, 8, 2, 8)\n"
        "assert torch.equal(ring_flash_attention(rq, rq, rq),\n"
        "    flash_attention.flash_attention(rq, rq, rq))\n"
        "assert ring_window_steps(4, 8, True, 3) == 2\n"
        "hvd.shutdown()\n"
        "from horovod_tpu_torch import guard, elastic, runner\n"
        "from horovod_tpu_torch.runner import elastic_driver, launch\n"
        "from horovod_tpu_torch.fleet import PreemptionGuard\n"
        "from horovod_tpu_torch.common import wire_auth\n"
        "hvd.init(device='cpu')\n"
        "gm = ResNetTiny(dtype=torch.float32, device='cpu')\n"
        "go = torch.optim.SGD(gm.parameters(), lr=0.1)\n"
        "gs = training.data_parallel_train_step(gm, go, guard=True)\n"
        "_, gl, gd = gs(training.create_train_state(gm, go),\n"
        "    torch.randn(2, 16, 16, 3), torch.tensor([1, 2]))\n"
        "assert bool(gd['finite']) and gd['digest'].shape == (2,)\n"
        "assert (gd['digest'].numpy() == guard.host_digest(\n"
        "    [p.grad for p in gm.parameters()])).all()\n"
        "es = elastic.TpuState(model=gm, optimizer=go, step=1)\n"
        "es.sync()\n"
        "hvd.shutdown()\n"
        "from horovod_tpu_torch import bench\n"
        "from horovod_tpu_torch.utils import profiler, timeline\n"
        "from horovod_tpu_torch.metrics import aggregate\n"
        "from horovod_tpu_torch.ops import overlap\n"
        "import os\n"
        "hvd.init(device='cpu')\n"
        "tp = os.path.join(tempfile.mkdtemp(), 't.json')\n"
        "hvd.start_timeline(tp)\n"
        "hvd.allreduce(torch.ones(2), name='blocked')\n"
        "hvd.stop_timeline()\n"
        "assert 'blocked' in open(tp).read()\n"
        "assert aggregate.cluster_snapshot()['ranks'] == 1\n"
        "hvd.shutdown()\n"
        "from horovod_tpu_torch.parallel import (ColumnParallelDense,\n"
        "    RowParallelDense, TensorParallelAttention, TensorParallelMlp,\n"
        "    transformer_shard_specs, tensor_shard_mesh, ExpertParallelMoe,\n"
        "    ulysses_attention, seq_to_heads, heads_to_seq)\n"
        "from horovod_tpu_torch.parallel import sharded, pipeline, _mesh_utils\n"
        "from horovod_tpu_torch.models.convert import shard_params\n"
        "hvd.init(device='cpu')\n"
        "one = tensor_shard_mesh('tp', 1)\n"
        "assert ServingEngine(cfg, p, serve=ServeConfig(block_size=4,\n"
        "    decode_tiers=(1, 2)), device='cpu', mesh=one).shards == 1\n"
        "assert shard_params(p, cfg, 0, 1)['layer_0.attn.q.kernel'] is \\\n"
        "    p['layer_0.attn.q.kernel']\n"
        "assert torch.equal(ulysses_attention(rq, rq, rq, impl='flash'),\n"
        "    flash_attention.flash_attention(rq, rq, rq))\n"
        "mo = ExpertParallelMoe(4, 8, 16, device='cpu')\n"
        "mo.reset_parameters(torch.Generator().manual_seed(0))\n"
        "assert mo(torch.randn(1, 4, 8))[0].shape == (1, 4, 8)\n"
        "assert pipeline.pipeline_apply(lambda w, h: h @ w, torch.eye(3),\n"
        "    torch.ones(2, 1, 3), 2).shape == (2, 1, 3)\n"
        "mesh = sharded.multi_axis_mesh(1, 1, 1)\n"
        "mm = sharded.MultiAxisTransformer(16, 8, 2, 1, 8, mesh=mesh,\n"
        "    attention_impl='ring_flash', device='cpu')\n"
        "sharded.init_sharded(mm)\n"
        "mopt, _ = sharded.init_opt_sharded(lambda ps: torch.optim.SGD(ps,\n"
        "    lr=0.1), mm)\n"
        "mstep = sharded.make_sharded_train_step(mm, mopt, mesh)\n"
        "_, ml = mstep(training.create_train_state(mm, mopt),\n"
        "    torch.randint(0, 16, (2, 8)), torch.randint(0, 16, (2, 8)))\n"
        "assert bool(torch.isfinite(ml))\n"
        "hvd.shutdown()\n"
        "from horovod_tpu_torch.common import topology\n"
        "from horovod_tpu_torch.ops import hierarchical\n"
        "from horovod_tpu_torch import DcnCompression, hierarchical_mesh\n"
        "hvd.init(device='cpu')\n"
        "assert hierarchical_mesh().tolist() == [[0]]\n"
        "assert topology.tiers() is None\n"
        "assert comm_model.modeled_collective_bytes((8,), 4, 2, 'bf16')[\n"
        "    'dcn_bytes'] == 8\n"
        "zm = torch.nn.Linear(3, 2)\n"
        "zo = hvd.ZeroDistributedOptimizer(torch.optim.SGD(\n"
        "    zm.parameters(), lr=0.1), hierarchical=True,\n"
        "    dcn_compression=DcnCompression('bfloat16', error_feedback=True))\n"
        "zm(torch.ones(1, 3)).sum().backward()\n"
        "zo.step()\n"
        "hvd.shutdown()\n"
        "assert eng.decode_step_inventory()['gather_bytes'] == 0\n"
        "assert eng.mixed_step_inventory()['gather_bytes'] > 0\n"
        "assert not any(m.split('.')[0] in ('jax', 'flax', 'optax') or\n"
        "    m == 'horovod_tpu' or m.startswith('horovod_tpu.')\n"
        "    for m, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_adapters_stay_out_of_the_package_and_import_no_jax():
    """The TensorFlow and Keras adapters are imported by name only:
    ``import horovod_tpu_torch`` and ``python -m
    horovod_tpu_torch.analysis`` leave ``tensorflow`` and ``keras`` out
    of ``sys.modules`` (the card's machine has neither).  No module of
    ``tensorflow/`` or ``keras/`` imports jax or ``horovod_tpu`` (AST
    scan), and, where TensorFlow is installed, both adapters import
    with those modules blocked.  The XLA bridge's library is built under
    ``build/horovod_tpu_torch/``."""
    files = sorted((PKG / "tensorflow").glob("*.py")) + sorted(
        (PKG / "keras").glob("*.py"))
    assert len(files) == 13
    offenders = [f"{f.relative_to(ROOT)}: {name}" for f in files
                 for name in _imported_modules(f) if _banned(name)]
    assert not offenders, offenders
    code = (
        "import runpy, sys\n"
        f"for m in {BANNED!r}: sys.modules[m] = None\n"
        "import horovod_tpu_torch\n"
        "sys.argv = ['analysis', '-q']\n"
        "try:\n"
        "    runpy.run_module('horovod_tpu_torch.analysis',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "assert not {'tensorflow', 'keras'} & set(sys.modules)\n"
        "from horovod_tpu_torch.ops import _build\n"
        "from horovod_tpu_torch.runner.launch import tf_bridge_path\n"
        "assert tf_bridge_path('2.0').parent == _build.BUILD_DIR\n"
        "assert not {'tensorflow', 'keras'} & set(sys.modules)\n"
        "assert _build.BUILD_DIR.parts[-2:] == ('build',\n"
        "    'horovod_tpu_torch')\n"
        "import importlib.util\n"
        "if importlib.util.find_spec('tensorflow') is not None:\n"
        "    import horovod_tpu_torch.tensorflow as t\n"
        "    import horovod_tpu_torch.keras as k\n"
        "    from horovod_tpu_torch.tensorflow import xla_ops\n"
        "    assert xla_ops.lib_path().startswith(str(_build.BUILD_DIR))\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), TF_CPP_MIN_LOG_LEVEL="3")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_analysis_imports_only_the_standard_library():
    """``horovod_tpu_torch.analysis`` imports nothing but the standard
    library and its own modules: no jax or ``horovod_tpu``, no torch,
    nothing of the port's runtime (AST scan).  The gated ``programs``
    pass runs the package's steps: inside its functions, and only
    there, it may import torch, numpy and the port's runtime."""
    files = sorted((PKG / "analysis").glob("*.py"))
    assert len(files) == 10
    stdlib = set(sys.stdlib_module_names) | {"__future__"}
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        in_function = set()
        if f.name == "programs.py":
            for fn in ast.walk(tree):
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    in_function.update(id(n) for n in ast.walk(fn))
        for node in ast.walk(tree):
            runtime = id(node) in in_function
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level == 1 or (runtime and node.level == 2), \
                    f"{f.name}: from {'.' * node.level}"
            elif isinstance(node, ast.ImportFrom):
                top = node.module.split(".")[0]
                assert top in stdlib or (runtime and top in (
                    "torch", "numpy")), f"{f.name}: {node.module}"
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    top = alias.name.split(".")[0]
                    assert top in stdlib or (runtime and top in (
                        "torch", "numpy")), f"{f.name}: {alias.name}"


def test_analysis_runs_with_torch_and_the_port_blocked():
    """The passes run, clean, with torch, jax and ``horovod_tpu``
    blocked and the port's package never executed (a stub parent, as
    ``tools/check.py`` loads the JAX package's checker)."""
    code = (
        "import sys, types\n"
        f"for m in {BANNED + ('torch',)!r}: sys.modules[m] = None\n"
        "stub = types.ModuleType('horovod_tpu_torch')\n"
        f"stub.__path__ = [{str(PKG)!r}]\n"
        "sys.modules['horovod_tpu_torch'] = stub\n"
        "from horovod_tpu_torch import analysis\n"
        f"assert analysis.run_all({str(ROOT)!r}) == []\n"
        f"rc = analysis.main(['--root', {str(ROOT)!r}, '-q'])\n"
        "loaded = sorted(m for m in sys.modules\n"
        "    if m.startswith('horovod_tpu_torch.'))\n"
        "assert all(m.startswith('horovod_tpu_torch.analysis')\n"
        "    for m in loaded), loaded\n"
        "print('rc', rc)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "rc 0"


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
    import horovod_tpu_torch as hvd

    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init()
    assert not hvd.is_initialized()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator().manual_seed(0),
                    param_dtype=torch.float32)
    from horovod_tpu_torch import data

    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.DevicePrefetcher(iter([]), depth=0)
    from horovod_tpu_torch.models import ResNetTiny

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResNetTiny()
    assert ResNetTiny(device="cpu").head.kernel.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params, role="prefill")
    from horovod_tpu_torch import bench

    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--batch", "2"])
    assert not hvd.is_initialized()
    from horovod_tpu_torch.parallel import (
        ColumnParallelDense, ExpertParallelMoe, TensorParallelAttention)
    from horovod_tpu_torch.parallel.sharded import MultiAxisTransformer

    for make in (lambda: MultiAxisTransformer(16, 8, 2, 1, 8),
                 lambda: ExpertParallelMoe(4, 8, 16),
                 lambda: ColumnParallelDense(8, 8),
                 lambda: TensorParallelAttention(2, 4, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert MultiAxisTransformer(16, 8, 2, 1, 8, device="cpu").embed \
        .device.type == "cpu"


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
