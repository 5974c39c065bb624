"""The port's KV snapshots (``kvsnap/1``) against the JAX package's.

* ``export_requests`` / ``export_blocks`` give the reference's dict, key
  for key and value for value, for the same engine state; the pages are
  byte-equal once the pools hold the same bytes, bf16 pages travelling
  as ``ml_dtypes.bfloat16`` arrays of the reference's bits, as the
  reference's do (``uint16`` bits where ``ml_dtypes`` is missing; same
  ``nbytes``).
* a bf16 snapshot of the port imports into the JAX engine bit-equal and
  resumes token-identically, in a speculative engine and through a
  prefill→decode router whose decode tier is the JAX engine; with
  ``ml_dtypes`` hidden the port's own round trip stays bit-equal.
* ``import_blocks`` verifies the chain before any state changes and
  rolls back all or nothing on pool exhaustion (the allocators agree
  step for step); an engine rejects pages of another element size or
  shape before any state changes.
* export then import resumes token-identically, within the port and
  across the packages in both directions.
* the ``source`` tag names the sender in every rejection; untagged
  snapshots still import.
"""

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.fleet.router import FleetRouter as JaxRouter
from horovod_tpu.models.transformer import Transformer as JaxTransformer
from horovod_tpu.models.transformer import TransformerConfig as JaxConfig
from horovod_tpu.serving import BlockAllocator as JaxAllocator
from horovod_tpu.serving import ServeConfig as JaxServeConfig
from horovod_tpu.serving import ServingEngine as JaxEngine
from horovod_tpu_torch.fleet.router import FleetRouter
from horovod_tpu_torch.models import TransformerConfig, params_from_flax
from horovod_tpu_torch.serving import engine as tengine
from horovod_tpu_torch.serving import (
    PREFIX_HASH_ROOT, BlockAllocator, ServeConfig, ServingEngine,
)

VOCAB = 97
SERVE = dict(block_size=4, num_blocks=25, token_budget=64, watermark=0,
             decode_tiers=(1, 2), prefill_chunk=8)
TOTAL = 18


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype):
    shape = dict(vocab_size=VOCAB, num_layers=2, num_heads=4, num_kv_heads=2,
                 head_dim=8, max_seq_len=64)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return JaxConfig(dtype=jdt, **shape), TransformerConfig(dtype=tdt, **shape)


@pytest.fixture(scope="module")
def models():
    jc, tc = _configs("float32")
    model = JaxTransformer(jc)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                        train=False)["params"]
    sd = params_from_flax(jax.tree.map(np.asarray, params), tc, device="cpu")
    return jc, tc, model, params, sd


def _prompt():
    return np.random.RandomState(18).randint(1, VOCAB, size=13).astype(
        np.int32)


def _interrupt(eng, rid, n=8):
    """Step ``eng`` until request ``rid`` has generated >= n tokens."""
    while True:
        seq = next((s for s in eng.scheduler.running if s.req.id == rid),
                   None)
        if seq is not None and len(seq.generated) >= n:
            return
        assert eng.step(), "request finished before the interruption"


@pytest.fixture(scope="module")
def exported(models):
    """One JAX and one port engine, the same request interrupted
    mid-decode at the same step, each exported; plus the uninterrupted
    stream."""
    jc, tc, _model, params, sd = models
    je = JaxEngine(jc, params, serve=JaxServeConfig(**SERVE))
    te = ServingEngine(tc, sd, serve=ServeConfig(**SERVE), device="cpu")
    prompt = _prompt()
    for eng in (je, te):
        rid = eng.submit(prompt, max_new_tokens=TOTAL)
        _interrupt(eng, rid)
    j_rec, t_rec = je.export_requests()[rid], te.export_requests()[rid]
    full = ServingEngine(tc, sd, serve=ServeConfig(**SERVE), device="cpu")
    frid = full.submit(prompt, max_new_tokens=TOTAL)
    want = full.run()[frid]
    return dict(je=je, te=te, rid=rid, prompt=prompt, jax=j_rec, port=t_rec,
                want=want)


def _same_fields(a, b):
    assert set(a) == set(b)
    for key in ("format", "block_size", "source"):
        assert a.get(key) == b.get(key), key
    for key in ("tokens", "hashes"):
        assert [int(x) for x in a[key]] == [int(x) for x in b[key]], key
    assert len(a["pages"]) == len(b["pages"])


def test_export_matches_jax_field_for_field(exported):
    """Same stream, same chain, same dict; the pages agree to rounding
    from independent runs and byte for byte from the same pool."""
    j_stream, j_snap, _ = exported["jax"]
    t_stream, t_snap, _ = exported["port"]
    np.testing.assert_array_equal(t_stream, j_stream)
    assert t_stream.dtype == j_stream.dtype == np.int32
    assert t_snap["format"] == JaxAllocator.SNAP_FORMAT \
        == BlockAllocator.SNAP_FORMAT
    assert len(t_snap["hashes"]) >= 2
    _same_fields(t_snap, j_snap)
    for (tk, tv), (jk, jv) in zip(t_snap["pages"], j_snap["pages"]):
        for t, j in ((tk, jk), (tv, jv)):
            assert t.shape == j.shape and t.dtype == j.dtype
            assert t.nbytes == j.nbytes
            np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)
    # the JAX engine's pool bytes in the port's pool: byte-equal pages
    te, je, rid = exported["te"], exported["je"], exported["rid"]
    k0, v0 = te.k_pool.clone(), te.v_pool.clone()
    try:
        te.k_pool.copy_(torch.from_numpy(np.array(je.k_pool)))
        te.v_pool.copy_(torch.from_numpy(np.array(je.v_pool)))
        snap = te.export_requests(rids=[rid])[rid][1]
    finally:
        te.k_pool.copy_(k0)
        te.v_pool.copy_(v0)
    for (tk, tv), (jk, jv) in zip(snap["pages"], j_snap["pages"]):
        assert tk.tobytes() == np.asarray(jk).tobytes()
        assert tv.tobytes() == np.asarray(jv).tobytes()


def test_bf16_pages_travel_as_uint16_bits():
    """numpy has no bfloat16: the port's bf16 pages are ml_dtypes
    bfloat16 arrays (the reference's page dtype) of the reference's
    bits, with the reference's nbytes; a JAX bf16 snapshot (ml_dtypes
    pages) imports into the port's bf16 engine."""
    jc, tc = _configs("bfloat16")
    model = JaxTransformer(jc)
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32),
                        train=False)["params"]
    sd = params_from_flax(jax.tree.map(np.asarray, params), tc, device="cpu")
    serve = dict(block_size=4, decode_tiers=(1,), prefill_tiers=(16, 64))
    je = JaxEngine(jc, params, serve=JaxServeConfig(**serve))
    te = ServingEngine(tc, sd, serve=ServeConfig(**serve), device="cpu")
    prompt = np.arange(3, 12, dtype=np.int32)  # 9 tokens: 2 full blocks
    for eng in (je, te):
        eng.submit(prompt, max_new_tokens=4)
        eng.step()  # the prefill step
    bits = lambda pool: torch.from_numpy(  # noqa: E731
        np.array(pool).view(np.int16)).view(torch.bfloat16)
    te.k_pool.copy_(bits(je.k_pool))
    te.v_pool.copy_(bits(je.v_pool))
    _s, j_snap, _a = je.export_requests()[0]
    _s, t_snap, _a = te.export_requests()[0]
    _same_fields(t_snap, j_snap)
    for (tk, tv), (jk, jv) in zip(t_snap["pages"], j_snap["pages"]):
        for t, j in ((tk, jk), (tv, jv)):
            assert t.dtype == np.asarray(j).dtype == ml_dtypes.bfloat16
            assert t.nbytes == np.asarray(j).nbytes
            assert t.tobytes() == np.asarray(j).tobytes()
    dst = ServingEngine(tc, sd, serve=ServeConfig(**serve), device="cpu")
    assert dst.import_kv(j_snap) == len(j_snap["hashes"])
    blocks, _ = dst.allocator.match_prefix(prompt, max_blocks=2)
    for (jk, jv), b in zip(j_snap["pages"], blocks):
        assert dst.k_pool[:, b].view(torch.int16).numpy().tobytes() \
            == np.asarray(jk).tobytes()
    dst.allocator.free(blocks)


def _alloc_script(cls):
    """The reference's import/rollback script over one allocator class;
    returns every outcome."""
    out = []
    a = cls(12, block_size=4)
    owner = a.alloc(2)
    h0 = a.register(owner[0], PREFIX_HASH_ROOT, [1, 2, 3, 4])
    a.register(owner[1], h0, [5, 6, 7, 8])
    snap = a.export_blocks(owner, [1, 2, 3, 4, 5, 6, 7, 8], source="r1")
    out.append(snap)
    b = cls(12, block_size=4)
    for bad in ({**snap, "tokens": [1, 2, 3, 4, 5, 6, 7, 9]},
                {**snap, "format": "nope"}, {**snap, "block_size": 8},
                {**snap, "hashes": snap["hashes"][:1]}):
        with pytest.raises(ValueError) as ei:
            b.import_blocks(bad)
        out.append((str(ei.value), b.free_blocks, b.cached_blocks,
                    list(b._ref)))
    blocks, fresh = b.import_blocks(snap)
    out.append((blocks, fresh))
    b.free(blocks)
    out.append(b.match_prefix([1, 2, 3, 4, 5, 6, 7, 8, 9], max_blocks=2))
    b.free(out[-1][0])
    out.append(b.import_blocks(snap))  # all index hits
    c = cls(2, block_size=4)  # one usable block: exhausted mid-chain
    with pytest.raises(ValueError) as ei:
        c.import_blocks(snap)
    out.append((str(ei.value), c.free_blocks, c.cached_blocks,
                list(c._ref), list(c._free), dict(c._index)))
    off = cls(12, block_size=4, prefix_cache=False)
    with pytest.raises(ValueError) as ei:
        off.import_blocks(snap)
    out.append(str(ei.value))
    return out


def test_import_verifies_chain_and_rolls_back_like_jax():
    port, ref = _alloc_script(BlockAllocator), _alloc_script(JaxAllocator)
    assert port == ref
    msgs = [o[0] for o in port[1:5]]
    assert "chain-hash mismatch" in msgs[0] and "from replica r1" in msgs[0]
    assert "pool exhausted" in port[-2][0]
    assert port[-2][1:] == (1, 0, [0, 0], [1], {})


def test_engine_rejects_foreign_pages_before_any_change(models, exported):
    """A chain whose pages have another element size or page shape, or
    a corrupt chain, raises ValueError and leaves the allocator and the
    pools untouched."""
    _jc, tc, _model, _params, sd = models
    snap = exported["port"][1]
    dst = ServingEngine(tc, sd, serve=ServeConfig(**SERVE), device="cpu")
    before = (dst.allocator.free_blocks, dst.allocator.cached_blocks,
              list(dst.allocator._ref), dst.k_pool.clone())
    as_f16 = {**snap, "pages": [(k.astype(np.float16), v.astype(np.float16))
                                for k, v in snap["pages"]]}
    cut = {**snap, "pages": [(k[:1], v[:1]) for k, v in snap["pages"]]}
    as_i32 = {**snap, "pages": [(k.view(np.int32), v.view(np.int32))
                                for k, v in snap["pages"]]}
    corrupt = {**snap, "tokens": list(snap["tokens"])}
    corrupt["tokens"][5] ^= 1
    for bad, match in ((as_f16, "does not fit"), (cut, "does not fit"),
                       (as_i32, "does not match"),
                       (corrupt, "chain-hash mismatch")):
        with pytest.raises(ValueError, match=match):
            dst.import_kv(bad)
        assert (dst.allocator.free_blocks, dst.allocator.cached_blocks,
                list(dst.allocator._ref)) == before[:3]
        assert torch.equal(dst.k_pool, before[3])
    bf = ServingEngine(TransformerConfig(**{**tc.__dict__,
                                            "dtype": torch.bfloat16}),
                       sd, serve=ServeConfig(**SERVE), device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        bf.import_kv(snap)  # fp32 pages, bf16 pool
    assert bf.allocator.cached_blocks == 0


@pytest.mark.parametrize("spec", [False, True])
def test_export_import_resumes_token_identical(models, exported, spec):
    """A request interrupted mid-decode, exported and re-registered in
    a fresh engine resumes bit-identical to uninterrupted decode, its
    re-prefill served from the imported chain, inside the warmup menu."""
    _jc, tc, _model, _params, sd = models
    serve = ServeConfig(**SERVE, spec=spec, spec_k=4)
    src = ServingEngine(tc, sd, serve=serve, device="cpu")
    prompt = exported["prompt"]
    rid = src.submit(prompt, max_new_tokens=TOTAL)
    _interrupt(src, rid)
    tokens, snap, _arr = src.export_requests()[rid]
    gen = np.asarray(tokens[len(prompt):], np.int32)
    tgt = ServingEngine(tc, sd, serve=serve, device="cpu")
    warmed = tgt.warmup()
    assert tgt.import_kv(snap) == len(snap["hashes"])
    rid2 = tgt.submit(np.concatenate([prompt, gen]),
                      max_new_tokens=TOTAL - gen.size)
    out = tgt.run()
    assert tgt.scheduler.prefix_hit_blocks >= len(snap["hashes"]) - 1
    assert tgt.program_count == warmed
    np.testing.assert_array_equal(np.concatenate([gen, out[rid2]]),
                                  exported["want"])


def test_snapshots_cross_the_packages_both_ways(models, exported):
    """A JAX-exported snapshot warm-imports into the port's engine and a
    port-exported one into the JAX engine; both resume to the same
    (uninterrupted) stream."""
    jc, tc, _model, params, sd = models
    prompt, want = exported["prompt"], exported["want"]
    for (tokens, snap, _arr), dst in (
            (exported["jax"], ServingEngine(tc, sd, serve=ServeConfig(
                **SERVE), device="cpu")),
            (exported["port"], JaxEngine(jc, params, serve=JaxServeConfig(
                **SERVE)))):
        gen = np.asarray(tokens[len(prompt):], np.int32)
        assert dst.import_kv(snap) == len(snap["hashes"])
        rid = dst.submit(np.concatenate([prompt, gen]),
                         max_new_tokens=TOTAL - gen.size)
        out = dst.run()
        assert dst.scheduler.prefix_hit_blocks >= len(snap["hashes"]) - 1
        np.testing.assert_array_equal(np.concatenate([gen, out[rid]]), want,
                                      err_msg=type(dst).__module__)


def test_source_tag_names_sender_and_untagged_imports(models):
    _jc, tc, _model, _params, sd = models
    serve = ServeConfig(**SERVE)
    src, dst = (ServingEngine(tc, sd, serve=serve, device="cpu")
                for _ in range(2))
    src.snap_source = "prefill7"
    rid = src.submit(np.arange(2, 19, dtype=np.int32), max_new_tokens=9)
    while not any(s.req.id == rid and s.tokens_in_cache >= 16
                  for s in src.scheduler.running):
        src.step()
    snap = src.export_requests(rids=[rid])[rid][1]
    assert snap["source"] == "prefill7"
    bad = {**snap, "tokens": np.array(snap["tokens"], np.int32)}
    bad["tokens"][3] ^= 1
    with pytest.raises(ValueError, match="from replica prefill7"):
        dst.import_kv(bad)
    with pytest.raises(ValueError, match="from replica prefill7"):
        dst.import_kv({**snap, "format": "bogus/9"})
    with pytest.raises(ValueError, match="from replica prefill7"):
        dst.import_kv({**snap, "pages": [(k[:1], v) for k, v in
                                         snap["pages"]]})
    assert dst.import_kv(dict(snap)) == len(snap["hashes"])
    untagged = {k: v for k, v in snap.items() if k != "source"}
    other = ServingEngine(tc, sd, serve=serve, device="cpu")
    assert other.import_kv(untagged) == len(snap["hashes"])
    bad = {**untagged, "tokens": np.array(snap["tokens"], np.int32)}
    bad["tokens"][0] ^= 1
    with pytest.raises(ValueError,
                       match=r"mismatch at block 0(?!.*from replica)"):
        ServingEngine(tc, sd, serve=serve, device="cpu").import_kv(bad)
    src.cancel(rid)


# -- bf16 snapshots from the port into the JAX engine ------------------------

BF16_SERVE = dict(SERVE, spec=True, spec_k=4)


@pytest.fixture(scope="module")
def bf16_models():
    """bf16 configs and weights (seed 0, matrices scaled by 4 so that
    the greedy streams vary instead of settling on one token)."""
    jc, tc = _configs("bfloat16")
    model = JaxTransformer(jc)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                        train=False)["params"]
    params = jax.tree.map(lambda x: x * 4 if x.ndim > 1 else x, params)
    sd = params_from_flax(jax.tree.map(np.asarray, params), tc, device="cpu")
    return jc, tc, params, sd


def _bits(pool):
    """A pool's bf16 bits as uint16 numpy, from either package."""
    if isinstance(pool, torch.Tensor):
        return pool.view(torch.int16).numpy().view(np.uint16)
    return np.array(pool).view(np.uint16)


def _interrupted_export(tc, sd, serve, prompt):
    src = ServingEngine(tc, sd, serve=ServeConfig(**serve), device="cpu")
    rid = src.submit(prompt, max_new_tokens=TOTAL)
    _interrupt(src, rid)
    tokens, snap, _arr = src.export_requests()[rid]
    return np.asarray(tokens[len(prompt):], np.int32), snap


def _full_stream(tc, sd, serve, prompt):
    eng = ServingEngine(tc, sd, serve=ServeConfig(**serve), device="cpu")
    rid = eng.submit(prompt, max_new_tokens=TOTAL)
    return eng.run()[rid]


def test_bf16_port_snapshot_imports_into_jax_bit_equal(bf16_models):
    """The speculative scenario: a bf16 port engine interrupted
    mid-decode exports its chain; the JAX engine imports it, holds the
    page bits exactly in its pool, and resumes to the port's
    uninterrupted stream, its re-prefill served from the chain."""
    jc, tc, params, sd = bf16_models
    prompt = _prompt()
    want = _full_stream(tc, sd, BF16_SERVE, prompt)
    gen, snap = _interrupted_export(tc, sd, BF16_SERVE, prompt)
    assert all(k.dtype == v.dtype == ml_dtypes.bfloat16
               for k, v in snap["pages"])
    dst = JaxEngine(jc, params, serve=JaxServeConfig(**BF16_SERVE))
    assert dst.import_kv(snap) == len(snap["hashes"])
    blocks, _ = dst.allocator.match_prefix(snap["tokens"],
                                           max_blocks=len(snap["hashes"]))
    assert len(blocks) == len(snap["hashes"])
    k_bits, v_bits = _bits(dst.k_pool), _bits(dst.v_pool)
    for (kp, vp), b in zip(snap["pages"], blocks):
        assert k_bits[:, b].tobytes() == kp.tobytes()
        assert v_bits[:, b].tobytes() == vp.tobytes()
    dst.allocator.free(blocks)
    rid = dst.submit(np.concatenate([prompt, gen]),
                     max_new_tokens=TOTAL - gen.size)
    out = dst.run()[rid]
    assert dst.scheduler.prefix_hit_blocks >= len(snap["hashes"]) - 1
    np.testing.assert_array_equal(np.concatenate([gen, out]), want)


def test_bf16_handoff_into_jax_decode_tier():
    """A prefill→decode router whose prefill tier is the port's bf16
    engine and whose decode tier is the JAX package's: every handoff is
    warm and every stream equals the all-JAX two-tier fleet's.  One
    layer, so that both packages' prefills write the same K/V bits (a
    deeper bf16 model's attention sums round differently, and its late
    tokens may fork at near-ties) and the streams can only differ where
    the import does."""
    shape = dict(vocab_size=VOCAB, num_layers=1, num_heads=4,
                 num_kv_heads=2, head_dim=8, max_seq_len=64)
    jc = JaxConfig(dtype=jnp.bfloat16, **shape)
    tc = TransformerConfig(dtype=torch.bfloat16, **shape)
    params = JaxTransformer(jc).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
        train=False)["params"]
    params = jax.tree.map(lambda x: x * 4 if x.ndim > 1 else x, params)
    sd = params_from_flax(jax.tree.map(np.asarray, params), tc, device="cpu")

    def jax_build(role="both"):
        return JaxEngine(jc, params, serve=JaxServeConfig(**SERVE),
                         role=role)

    def build(role="both"):
        if role == "prefill":
            return ServingEngine(tc, sd, serve=ServeConfig(**SERVE),
                                 device="cpu", role=role)
        return jax_build(role)

    rs = np.random.RandomState(31)
    prompts = [rs.randint(1, VOCAB, size=n).astype(np.int32)
               for n in (9, 13, 17, 21)]
    streams = []
    for router_cls, factory in ((FleetRouter, build),
                                (JaxRouter, jax_build)):
        router = router_cls(factory, replicas=1, prefill_replicas=1)
        gids = [router.submit(p, 12) for p in prompts]
        got = router.run_until_drained()
        assert router.handoffs == {"warm": len(prompts), "cold": 0}
        streams.append([np.asarray(got[g]) for g in gids])
    assert {type(r.engine) for r in router.replicas} == {JaxEngine}
    for i, (got, want) in enumerate(zip(*streams)):
        np.testing.assert_array_equal(got, want, err_msg=f"request {i}")


def test_bf16_pages_fall_back_to_uint16_without_ml_dtypes(bf16_models,
                                                          monkeypatch):
    """Where ml_dtypes is missing (the engine's guarded import found
    none) bf16 pages are uint16 bits, and the port's own round trip
    stays bit-equal and token-identical."""
    _jc, tc, _params, sd = bf16_models
    monkeypatch.setattr(tengine, "_BF16", None)
    prompt = _prompt()
    want = _full_stream(tc, sd, BF16_SERVE, prompt)
    gen, snap = _interrupted_export(tc, sd, BF16_SERVE, prompt)
    assert all(k.dtype == v.dtype == np.uint16 for k, v in snap["pages"])
    dst = ServingEngine(tc, sd, serve=ServeConfig(**BF16_SERVE),
                        device="cpu")
    assert dst.import_kv(snap) == len(snap["hashes"])
    blocks, _ = dst.allocator.match_prefix(snap["tokens"],
                                           max_blocks=len(snap["hashes"]))
    for (kp, vp), b in zip(snap["pages"], blocks):
        assert _bits(dst.k_pool[:, b]).tobytes() == kp.tobytes()
        assert _bits(dst.v_pool[:, b]).tobytes() == vp.tobytes()
    dst.allocator.free(blocks)
    rid = dst.submit(np.concatenate([prompt, gen]),
                     max_new_tokens=TOTAL - gen.size)
    np.testing.assert_array_equal(
        np.concatenate([gen, dst.run()[rid]]), want)


def test_engine_imports_without_ml_dtypes():
    """The engine module imports on a machine without ml_dtypes (its
    import is guarded) and then exports uint16 bits."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['ml_dtypes'] = None\n"
            "from horovod_tpu_torch.serving import engine\n"
            "assert engine._BF16 is None\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(__import__("pathlib").Path(__file__).parents[1]))
