"""The port's contract checker (``horovod_tpu_torch.analysis``) against
the JAX package's (``horovod_tpu.analysis``).

* The real tree: ``run_all`` over the port finds nothing, inside the
  JAX suite's 10-second budget; the ``env``, ``metrics``, ``chaos``,
  ``trace`` and ``locks`` passes, pointed at the JAX package's layout
  (``analysis.JAX``), return exactly the JAX passes' findings (check,
  file, line, key) before suppression, and the full run with the
  suppressions applied agrees too.
* Synthetic trees: every case of ``tests/test_static_analysis.py`` and
  ``tests/test_trace.py`` for those five passes, and the rank-gated and
  marker cases of ``collectives``, built once under ``horovod_tpu/``
  for the JAX pass and once under ``horovod_tpu_torch/`` for the
  port's: the same findings with the prefix renamed, and the ones the
  JAX tests expect.
* The port's ``torch.distributed`` rule: its flagged and allowed
  spellings.
* The allowlist (a fixed path inside the package, never
  ``pyproject.toml``'s key): a well-formed entry suppresses, a
  malformed one and one without a justification are reported, a stale
  one is reported on a full run; and ``main``'s exit codes, 2 for
  ``c-api`` and ``programs``.
"""

import dataclasses
import os
import time

import pytest

from horovod_tpu import analysis as jaxa
from horovod_tpu_torch import analysis
from horovod_tpu_torch.analysis import _common

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARED = ("env", "metrics", "chaos", "trace", "locks")


def _write(root, rel, text):
    path = os.path.join(str(root), rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _keys(findings):
    return sorted((f.check, f.file, f.line, f.key) for f in findings)


# -- the real tree ------------------------------------------------------------


def test_port_holds_every_contract_fast():
    t0 = time.perf_counter()
    stats = {}
    findings = analysis.run_all(REPO, stats=stats)
    elapsed = time.perf_counter() - t0
    assert not findings, "\n".join(f.render() for f in findings)
    assert elapsed < 10.0, f"analysis took {elapsed:.1f}s (budget 10s)"
    assert stats["allowlisted"] > 0 and stats["raw"] >= stats["allowlisted"]


@pytest.mark.parametrize("name", SHARED)
def test_pass_on_the_jax_layout_equals_the_jax_pass(name):
    got = _keys(analysis.PASSES[name](REPO, analysis.JAX))
    assert got == _keys(jaxa.PASSES[name](REPO))


def test_suppressed_run_on_the_jax_layout_equals_the_jax_run():
    got = analysis.run_all(REPO, list(SHARED), layout=analysis.JAX)
    assert _keys(got) == _keys(jaxa.run_all(REPO, list(SHARED)))


# -- synthetic trees, one per case of the JAX package's tests ----------------

_RUNNING = """\
| Variable | Meaning |
|---|---|
| `HVD_TPU_KNOWN` | documented knob |
"""
_READ_KNOWN = 'import os\nv = os.environ.get("HVD_TPU_KNOWN")\n'
_CHAOS_INIT = 'SITES = (\n    "transport.frame.send",\n    "module.step",\n)\n'
_FAULT_MD = ("| site | layer |\n|---|---|\n"
             "| `transport.frame.send` | native |\n"
             "| `module.step` | python |\n")
_POINT = 'def f():\n    point("module.step")\n'
_DECIDE = 'Decide("transport.frame.send");\n'
_LOCKS_HEAD = "import threading\n\n\n"
_COUNTER = _LOCKS_HEAD + (
    "class Counter:\n"
    "    def __init__(self):\n"
    "        self._lock = threading.Lock()\n"
    "        self.n = 0\n"
    "        threading.Thread(target=self._run).start()\n\n"
    "    def _run(self):\n"
    "        with self._lock:\n"
    "            self.n = 1\n\n"
    "    def reset(self):\n")


def _trace_tree(catalogue, code, documented):
    return {
        "PKG/trace/__init__.py": "SITES = (\n" + "".join(
            f'    "{s}",\n' for s in catalogue) + ")\n",
        "PKG/mod.py": code,
        "docs/TRACING.md": "| site | kind |\n|---|---|\n" + "".join(
            f"| `{s}` | span |\n" for s in documented),
    }


#: case -> (pass, {path: text} with PKG for the package, the keys the
#: JAX tests expect)
CASES = {
    "env_clean": ("env", {"docs/running.md": _RUNNING,
                          "PKG/mod.py": _READ_KNOWN}, []),
    "env_undocumented_read": ("env", {
        "docs/running.md": _RUNNING,
        "PKG/mod.py": _READ_KNOWN + 'v = os.environ.get("HVD_TPU_SURPRISE")\n',
    }, ["HVD_TPU_SURPRISE"]),
    "env_tools_reads_scoped": ("env", {
        "docs/running.md": _RUNNING + "| `HVD_TPU_TOOL_DOCED` | bench knob |\n",
        "PKG/mod.py": _READ_KNOWN,
        "tools/bench.py": ('import os\n'
                           'a = os.environ.get("HVD_TPU_TOOL_DOCED")\n'
                           'b = os.environ.get("HVD_TPU_TOOL_SURPRISE")\n'),
    }, []),
    "env_stale_doc_row": ("env", {
        "docs/running.md": _RUNNING + "| `HVD_TPU_GONE` | removed knob |\n",
        "PKG/mod.py": _READ_KNOWN,
    }, ["HVD_TPU_GONE"]),
    "env_raw_parse_and_wildcard": ("env", {
        "docs/running.md": _RUNNING + "and the `HVD_TPU_FAM_*` family\n",
        "PKG/mod.py": ('import os\n'
                       'n = int(os.environ.get("HVD_TPU_KNOWN", "1"))\n'
                       'f = os.environ.get("HVD_TPU_FAM_A")\n'),
    }, ["HVD_TPU_KNOWN"]),
    "env_native_reads": ("env", {
        "docs/running.md": _RUNNING,
        "PKG/mod.py": _READ_KNOWN,
        "PKG/native/src/x.h": ('#include <cstdlib>\n'
                               'auto v = std::getenv("HVD_TPU_NATIVE_ONLY");\n'),
    }, ["HVD_TPU_NATIVE_ONLY"]),
    "env_inline_marker": ("env", {
        "docs/running.md": _RUNNING,
        "PKG/mod.py": ('import os\n'
                       '# contract-ok: env -- launcher-set, garbage must crash\n'
                       'n = int(os.environ.get("HVD_TPU_KNOWN", "1"))\n'),
    }, []),
    "env_bare_marker_reported": ("env", {
        "docs/running.md": _RUNNING,
        "PKG/mod.py": ('import os\n'
                       '# contract-ok: env\n'
                       'n = int(os.environ.get("HVD_TPU_KNOWN", "1"))\n'),
    }, ["HVD_TPU_KNOWN"]),
    "metrics_clean": ("metrics", {
        "PKG/metrics/instruments.py": 'A = counter("hvd_tpu_a_total", "doc")\n',
        "docs/METRICS.md": "catalogue: `hvd_tpu_a_total`\n",
    }, []),
    "metrics_uncatalogued": ("metrics", {
        "PKG/metrics/instruments.py": 'A = counter("hvd_tpu_a_total", "doc")\n',
        "docs/METRICS.md": "catalogue: `hvd_tpu_a_total`\n",
        "PKG/mod.py": 'r = counter("hvd_tpu_rogue_total", "undeclared")\n',
    }, ["hvd_tpu_rogue_total"]),
    "metrics_undocumented_and_stale": ("metrics", {
        "PKG/metrics/instruments.py": ('A = counter("hvd_tpu_a_total", "doc")\n'
                                       'B = gauge("hvd_tpu_b", "doc")\n'),
        "docs/METRICS.md": "catalogue: `hvd_tpu_a_total` and `hvd_tpu_vanished`\n",
    }, ["hvd_tpu_b", "hvd_tpu_vanished"]),
    "metrics_brace_expansion": ("metrics", {
        "PKG/metrics/instruments.py": (
            'H = gauge("hvd_tpu_cache_hits", "d")\n'
            'M = gauge("hvd_tpu_cache_misses", "d")\n'
            'S = gauge("hvd_tpu_t_seconds", "d", ["phase"])\n'),
        "docs/METRICS.md": ("`hvd_tpu_cache_{hits,misses}` and "
                            "`hvd_tpu_t_seconds{phase}`\n"),
    }, []),
    "chaos_clean": ("chaos", {
        "PKG/chaos/__init__.py": _CHAOS_INIT, "docs/FAULT_TOLERANCE.md": _FAULT_MD,
        "PKG/mod.py": _POINT, "PKG/native/src/t.h": _DECIDE,
    }, []),
    "chaos_undocumented_site": ("chaos", {
        "PKG/chaos/__init__.py": _CHAOS_INIT,
        "docs/FAULT_TOLERANCE.md": ("| site | layer |\n|---|---|\n"
                                    "| `transport.frame.send` | native |\n"),
        "PKG/mod.py": _POINT, "PKG/native/src/t.h": _DECIDE,
    }, ["module.step"]),
    "chaos_uncatalogued_point_and_dead_entry": ("chaos", {
        "PKG/chaos/__init__.py": _CHAOS_INIT, "docs/FAULT_TOLERANCE.md": _FAULT_MD,
        "PKG/mod.py": 'def f():\n    raise_point("rogue.site")\n',
        "PKG/native/src/t.h": _DECIDE,
    }, ["module.step", "rogue.site"]),
    "chaos_native_divergence": ("chaos", {
        "PKG/chaos/__init__.py": _CHAOS_INIT, "docs/FAULT_TOLERANCE.md": _FAULT_MD,
        "PKG/mod.py": _POINT,
        "PKG/native/src/t.h": _DECIDE + 'Decide("transport.frame.recv");\n',
    }, ["transport.frame.recv"]),
    "trace_clean": ("trace", _trace_tree(
        ["train.step", "serve.finish"],
        'from . import trace\n'
        'with trace.span("train.step", step=1):\n'
        '    trace.event("serve.finish")\n',
        ["train.step", "serve.finish"]), []),
    "trace_every_drift_class": ("trace", _trace_tree(
        ["train.step", "dead.site", "undocumented.site"],
        'from . import trace\n'
        'trace.event("train.step")\n'
        'trace.event("undocumented.site")\n'
        'trace.add_span("rogue.site", 0, 1)\n',
        ["train.step", "ghost.site"]),
        ["dead.site", "dead.site", "ghost.site", "rogue.site",
         "undocumented.site"]),  # dead.site: dead and undocumented
    "locks_clean": ("locks", {"PKG/pool.py": _LOCKS_HEAD + (
        "class Pool:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._items = []\n"
        "        threading.Thread(target=self._worker).start()\n\n"
        "    def _worker(self):\n"
        "        with self._lock:\n"
        "            self._items = []\n\n"
        "    def add(self, x):\n"
        "        with self._lock:\n"
        "            self._items = [x]\n")}, []),
    "locks_order_inversion": ("locks", {"PKG/pair.py": _LOCKS_HEAD + (
        "class Pair:\n"
        "    def __init__(self):\n"
        "        self._a = threading.Lock()\n"
        "        self._b = threading.Lock()\n\n"
        "    def one(self):\n"
        "        with self._a:\n"
        "            with self._b:\n"
        "                pass\n\n"
        "    def two(self):\n"
        "        with self._b:\n"
        "            with self._a:\n"
        "                pass\n")}, ["Pair._a->Pair._b->Pair._a"]),
    "locks_interprocedural_inversion": ("locks", {
        "PKG/indirect.py": _LOCKS_HEAD + (
            "class Indirect:\n"
            "    def __init__(self):\n"
            "        self._a = threading.Lock()\n"
            "        self._b = threading.Lock()\n\n"
            "    def take_b(self):\n"
            "        with self._b:\n"
            "            pass\n\n"
            "    def take_a(self):\n"
            "        with self._a:\n"
            "            pass\n\n"
            "    def one(self):\n"
            "        with self._a:\n"
            "            self.take_b()\n\n"
            "    def two(self):\n"
            "        with self._b:\n"
            "            self.take_a()\n")},
        ["Indirect._a->Indirect._b->Indirect._a"]),
    "locks_mixed_guarded_unguarded_write": ("locks", {
        "PKG/counter.py": _COUNTER + "        self.n = 0\n"}, ["Counter.n"]),
    "locks_thread_target_write_race": ("locks", {
        "PKG/racer.py": _LOCKS_HEAD + (
            "class Racer:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self.state = 0\n"
            "        threading.Thread(target=self._run).start()\n\n"
            "    def _run(self):\n"
            "        self.state = 1\n\n"
            "    def poke(self):\n"
            "        self.state = 2\n")}, ["Racer.state"]),
    "locks_unthreaded_class": ("locks", {"PKG/single.py": _LOCKS_HEAD + (
        "class Single:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.n = 0\n\n"
        "    def guarded(self):\n"
        "        with self._lock:\n"
        "            self.n = 1\n\n"
        "    def bare(self):\n"
        "        self.n = 2\n")}, []),
    "locks_inline_marker": ("locks", {"PKG/counter.py": _COUNTER + (
        "        # contract-ok: locks -- reset only runs pre-start\n"
        "        self.n = 0\n")}, []),
    "collectives_clean": ("collectives", {
        "PKG/ops/spmd.py": "import jax\ndef f(x):\n    return jax.lax.psum(x, 'w')\n",
        "PKG/mod.py": ("import jax.numpy as jnp\n"
                       "def g(x, size):\n"
                       "    if size > 1:\n"
                       "        x = allreduce(x)\n"
                       "    return jnp.broadcast_to(x, (2,) + x.shape)\n"),
    }, []),
    "collectives_rank_gated_allreduce": ("collectives", {"PKG/mod.py": (
        "def g(x, rank):\n"
        "    if rank == 0:\n"
        "        x = allreduce(x)\n"
        "    return x\n")}, ["allreduce"]),
    "collectives_rank_gated_else_arm": ("collectives", {"PKG/mod.py": (
        "def g(x):\n"
        "    if process_index() == 0:\n"
        "        pass\n"
        "    else:\n"
        "        x = barrier(x)\n"
        "    return x\n")}, ["barrier"]),
    "collectives_inline_marker": ("collectives", {"PKG/train2.py": (
        "import jax\n"
        "def step(g, axes):\n"
        "    # contract-ok: collectives -- tuple-axis psum the public "
        "API cannot spell\n"
        "    return jax.lax.psum(g, axes)\n")}, []),
}


def _tree(root, files, package):
    for rel, text in files.items():
        _write(root, rel.replace("PKG/", package + "/"), text)
    return str(root)


#: the port's layout, except that tools/ reads legitimize doc rows as on
#: the JAX package's: the shared cases then hold case for case
_PORT_WITH_TOOLS = dataclasses.replace(_common.PORT,
                                       tools_dir=_common.JAX.tools_dir)


@pytest.mark.parametrize("case", sorted(CASES))
def test_synthetic_case_matches_the_jax_pass(case, tmp_path):
    name, files, want = CASES[case]
    jroot = _tree(tmp_path / "jax", files, "horovod_tpu")
    proot = _tree(tmp_path / "port", files, "horovod_tpu_torch")
    renamed = [(c, f.replace("horovod_tpu/", "horovod_tpu_torch/", 1), ln, k)
               for c, f, ln, k in _keys(jaxa.run_all(jroot, [name]))]
    got = analysis.run_all(proot, [name], layout=_PORT_WITH_TOOLS)
    assert _keys(got) == sorted(renamed)
    assert sorted(f.key for f in got) == want
    if case == "env_bare_marker_reported":
        assert [f.check for f in got] == ["allowlist"]
        assert "no justification" in got[0].message


def test_tools_reads_do_not_make_a_port_row_live(tmp_path):
    """On the port's own layout only horovod_tpu_torch/ makes a
    documented row live: a row read only under tools/ (the JAX
    package's scripts) is reported as stale, and tools/ reads still
    raise no findings of their own."""
    _, files, _ = CASES["env_tools_reads_scoped"]
    root = _tree(tmp_path, files, "horovod_tpu_torch")
    got = analysis.run_all(root, ["env"])
    assert [(f.file, f.key) for f in got] == \
        [("docs/running.md", "HVD_TPU_TOOL_DOCED")]
    assert analysis.run_all(root, ["env"], layout=_PORT_WITH_TOOLS) == []


# -- the port's torch.distributed rule ---------------------------------------

_DIST = "import torch.distributed as dist\n"

TORCH_CASES = {
    "dist_all_reduce_in_training": (
        {"training.py": _DIST + "def f(x):\n    dist.all_reduce(x)\n"},
        [("horovod_tpu_torch/training.py", 3, "dist.all_reduce")]),
    "torch_distributed_broadcast_object_list": (
        {"fleet/x.py": "import torch\ndef f(b):\n"
                       "    torch.distributed.broadcast_object_list(b, src=0)\n"},
        [("horovod_tpu_torch/fleet/x.py", 3, "dist.broadcast_object_list")]),
    "from_import_all_gather": (
        {"functions.py": "from torch.distributed import all_gather\n"
                         "def f(out, x):\n    all_gather(out, x)\n"},
        [("horovod_tpu_torch/functions.py", 3, "dist.all_gather")]),
    "aliased_module_reduce_scatter_tensor": (
        {"guard.py": "import torch.distributed as td\n"
                     "def f(o, x):\n    td.reduce_scatter_tensor(o, x)\n"},
        [("horovod_tpu_torch/guard.py", 3, "dist.reduce_scatter_tensor")]),
    "send_recv_barrier": (
        {"serving/e.py": _DIST + "def f(x):\n    dist.isend(x, 1)\n"
                                 "    dist.recv(x, 0)\n    dist.barrier()\n"},
        [("horovod_tpu_torch/serving/e.py", 3, "dist.isend"),
         ("horovod_tpu_torch/serving/e.py", 4, "dist.recv"),
         ("horovod_tpu_torch/serving/e.py", 5, "dist.barrier")]),
    "allowed_under_ops_and_parallel": (
        {"ops/c.py": _DIST + "from torch.distributed import all_gather\n"
                             "def f(o, x):\n    dist.all_reduce(x)\n"
                             "    all_gather(o, x)\n",
         "parallel/p.py": "import torch\ndef f(b):\n"
                          "    torch.distributed.broadcast_object_list(b)\n"},
        []),
    "lookalikes_are_not_collectives": (
        {"training.py": _DIST + "def f():\n    r = dist.get_rank()\n"
                                "    ok = dist.is_initialized()\n"
                                "    g = dist.new_group([0])\n"
                                "    return dist.get_world_size(g), r, ok\n"},
        []),
    "marked_call_allowed": (
        {"training.py": _DIST + "def f(x):\n"
                                "    # contract-ok: collectives -- every rank "
                                "calls f\n    dist.broadcast(x, 0)\n"},
        []),
}


@pytest.mark.parametrize("case", sorted(TORCH_CASES))
def test_torch_distributed_rule(case, tmp_path):
    files, want = TORCH_CASES[case]
    root = _tree(tmp_path, {"PKG/" + k: v for k, v in files.items()},
                 "horovod_tpu_torch")
    got = analysis.run_all(root, ["collectives"])
    assert [(f.file, f.line, f.key) for f in got] == want
    assert all("outside ops//parallel/" in f.message for f in got)


def test_torch_rule_bare_marker_is_reported(tmp_path):
    root = _tree(tmp_path, {"PKG/training.py": _DIST + (
        "def f(x):\n    # contract-ok: collectives\n    dist.broadcast(x, 0)\n")},
        "horovod_tpu_torch")
    got = analysis.run_all(root, ["collectives"])
    assert [(f.check, f.key) for f in got] == [("allowlist", "dist.broadcast")]


# -- the allowlist and the entry point ---------------------------------------


def test_allowlist_fixed_path_suppresses_and_audits(tmp_path):
    # pyproject's key names another file: the port never reads it
    _write(tmp_path, "pyproject.toml",
           '[tool.horovod_tpu.analysis]\nallowlist = "other.txt"\n')
    _write(tmp_path, "other.txt",
           "env:HVD_TPU_OTHER -- would suppress, but is never read\n")
    _write(tmp_path, _common.PORT.allowlist, (
        "# comment\n"
        "env:HVD_TPU_SURPRISE -- a vendor reads it, its row comes later\n"
        "env:HVD_TPU_NEVER_MATCHES -- stale entry\n"
        "env:HVD_TPU_OTHER --\n"
        "malformed line without separator\n"))
    _write(tmp_path, "docs/running.md", _RUNNING)
    _write(tmp_path, "horovod_tpu_torch/mod.py", _READ_KNOWN + (
        'v = os.environ.get("HVD_TPU_SURPRISE")\n'
        'w = os.environ.get("HVD_TPU_OTHER")\n'))
    subset = analysis.run_all(str(tmp_path), ["env"])
    assert sorted((f.check, f.key) for f in subset) == [
        ("allowlist", "env:HVD_TPU_OTHER --"), ("allowlist",
                                                "malformed line without "
                                                "separator"),
        ("env", "HVD_TPU_OTHER")]
    assert all("malformed" in f.message for f in subset
               if f.check == "allowlist")
    stats = {}
    full = analysis.run_all(str(tmp_path), stats=stats)
    stale = [f.key for f in full if "stale allowlist" in f.message]
    assert stale == ["env:HVD_TPU_NEVER_MATCHES"]
    assert stats["allowlisted"] == 2


def test_main_exit_codes(tmp_path, capsys):
    _write(tmp_path, "docs/running.md", "| Variable | Meaning |\n")
    _write(tmp_path, "horovod_tpu_torch/mod.py",
           'import os\nv = os.environ.get("HVD_TPU_SURPRISE")\n')
    assert analysis.main(["--root", str(tmp_path), "env"]) == 1
    assert "horovod_tpu_torch/mod.py:2: [env]" in capsys.readouterr().out
    _write(tmp_path, "docs/running.md",
           "| Variable | Meaning |\n| `HVD_TPU_SURPRISE` | documented |\n")
    assert analysis.main(["--root", str(tmp_path), "env"]) == 0
    assert analysis.main(["--root", str(tmp_path), "nonesuch"]) == 2
    assert "unknown pass" in capsys.readouterr().err


@pytest.mark.parametrize("name,item", [("c-api", "A13b")])
def test_unported_passes_exit_2_naming_their_roadmap_item(name, item,
                                                          capsys):
    assert analysis.main(["--root", REPO, "env", name]) == 2
    err = capsys.readouterr().err
    assert f"ROADMAP {item}" in err and "not ported" in err
    with pytest.raises(ValueError, match=item):
        analysis.run_all(REPO, [name])
    assert name in jaxa.PASSES and name not in analysis.PASSES
