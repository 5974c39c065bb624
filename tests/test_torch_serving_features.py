"""The port's staged intake, cancellation, static baseline and prefill
role against the JAX package's.

* ``attach_source`` (prompts staged by the data pipeline's prefetcher)
  serves the same streams as ``submit`` and as the JAX engine's staged
  path; sourced-id collisions are rejected; the queue-depth gauge counts
  staged rows.
* ``cancel`` / ``cancel_all`` abort running, pending and staged work
  (with a live staging producer), freeing every block.
* ``run_static`` streams equal the JAX engine's ``run_static``.
* ``role="prefill"``: the JAX engine's mixed-only menu, the handoff
  boundary (stream = prompt + first token, the chain parked matchable),
  short requests finishing locally, and no decode or verify step ever
  run.
"""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.models.transformer import Transformer as JaxTransformer
from horovod_tpu.models.transformer import TransformerConfig as JaxConfig
from horovod_tpu.serving import Request as JaxRequest
from horovod_tpu.serving import ServeConfig as JaxServeConfig
from horovod_tpu.serving import ServingEngine as JaxEngine
from horovod_tpu_torch.metrics import instruments as _instr
from horovod_tpu_torch.models import TransformerConfig, params_from_flax
from horovod_tpu_torch.serving import (
    Request, ServeConfig, ServingEngine,
)

VOCAB = 97


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    shape = dict(vocab_size=VOCAB, num_layers=2, num_heads=4, num_kv_heads=2,
                 head_dim=8, max_seq_len=64)
    jc = JaxConfig(dtype=jnp.float32, **shape)
    tc = TransformerConfig(dtype=torch.float32, **shape)
    model = JaxTransformer(jc)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                        train=False)["params"]
    sd = params_from_flax(jax.tree.map(np.asarray, params), tc, device="cpu")
    return jc, tc, params, sd


def _prompts(seed, n, lo=3, hi=20):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, VOCAB, size=rs.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


SERVE = dict(block_size=8, token_budget=128, watermark=2,
             decode_tiers=(1, 2, 4))


def test_staged_source_matches_submit_and_jax(models):
    jc, tc, params, sd = models
    prompts = _prompts(3, 5)
    te = ServingEngine(tc, sd, serve=ServeConfig(**SERVE), device="cpu")
    te.attach_source(iter([Request(id=i, prompt=p, max_new_tokens=6)
                           for i, p in enumerate(prompts)]))
    staged = te.run()
    assert te._staging.source_kind == "serving"
    sub = ServingEngine(tc, sd, serve=ServeConfig(**SERVE), device="cpu")
    ids = [sub.submit(p, max_new_tokens=6) for p in prompts]
    submitted = sub.run()
    je = JaxEngine(jc, params, serve=JaxServeConfig(**SERVE))
    je.attach_source(iter([JaxRequest(id=i, prompt=p, max_new_tokens=6)
                           for i, p in enumerate(prompts)]))
    ref = je.run()
    for i, rid in enumerate(ids):
        np.testing.assert_array_equal(staged[i], submitted[rid])
        np.testing.assert_array_equal(staged[i], np.asarray(ref[i]))
    # a second source re-arms the same prefetcher
    te.attach_source(iter([Request(id=10, prompt=prompts[0],
                                   max_new_tokens=6)]))
    np.testing.assert_array_equal(te.run()[10], staged[0])


def test_staged_row_used_only_when_it_is_the_whole_chunk(models):
    """The staged device row feeds the step only when it IS the chunk at
    the step's width; a longer prompt is chunked from the host."""
    _jc, tc, _params, sd = models
    eng = ServingEngine(tc, sd, serve=ServeConfig(
        **dict(SERVE, prefill_chunk=16, prefill_tiers=(16, 32, 64))),
        device="cpu")
    used = []
    orig = eng._chunk_row

    def spy(s, c, width):
        row = orig(s, c, width)
        used.append((len(s.context), isinstance(row, torch.Tensor)))
        return row
    eng._chunk_row = spy
    eng.attach_source(iter([
        Request(id=0, prompt=np.arange(1, 15, dtype=np.int32),
                max_new_tokens=2),
        Request(id=1, prompt=np.arange(1, 41, dtype=np.int32),
                max_new_tokens=2)]))
    out = eng.run()
    assert (14, True) in used and (40, False) in used
    assert (40, True) not in used
    assert len(out[0]) == 2 and len(out[1]) == 2


def test_sourced_id_collision_rejected(models):
    _jc, tc, _params, sd = models
    eng = ServingEngine(tc, sd, serve=ServeConfig(**SERVE), device="cpu")
    rid = eng.submit(np.ones((4,), np.int32), max_new_tokens=2)
    eng.attach_source(iter([Request(id=rid, prompt=np.ones((4,), np.int32),
                                    max_new_tokens=2)]))
    with pytest.raises(ValueError, match="already in use"):
        eng.run()
    with pytest.raises(RuntimeError, match="already attached"):
        eng.attach_source(iter([]))


def test_queue_depth_gauge_counts_staged_rows(models):
    _jc, tc, _params, sd = models
    eng = ServingEngine(tc, sd, serve=ServeConfig(**SERVE), device="cpu")
    reqs = [Request(id=i, prompt=np.ones((8,), np.int32), max_new_tokens=2)
            for i in range(6)]
    eng.attach_source(iter(reqs), depth=8)
    deadline = time.time() + 10
    while len(eng._staging_meta) < 6 and time.time() < deadline:
        time.sleep(0.01)
    assert len(eng._staging_meta) == 6, "staging never filled"
    assert eng.scheduler.queue_depth() == 6
    eng.scheduler._book()
    assert _instr.SERVE_QUEUE_DEPTH.get() == 6
    eng._drain_staging(block=True)
    assert eng.scheduler.queue_depth() == len(eng.scheduler.pending) \
        + len(eng._staging_meta)
    assert _instr.SERVE_QUEUE_DEPTH.get() == eng.scheduler.queue_depth()
    eng.run()
    assert _instr.SERVE_QUEUE_DEPTH.get() == 0


def test_cancel_and_cancel_all(models):
    _jc, tc, _params, sd = models
    eng = ServingEngine(tc, sd, serve=ServeConfig(**SERVE), device="cpu")
    free0 = eng.allocator.free_blocks
    rid_run = eng.submit(np.arange(1, 9), max_new_tokens=20)
    for _ in range(3):
        eng.step()  # mid-decode
    rid_pend = eng.submit(np.arange(2, 10), max_new_tokens=5)
    rid_gone = eng.submit(np.arange(3, 10), max_new_tokens=5)
    assert eng.cancel(rid_gone) and not eng.cancel(12345)
    eng.attach_source(iter([Request(id=500, prompt=np.arange(3, 11),
                                    max_new_tokens=4)]))
    eng._drain_staging(block=True)
    eng.cancel_all()
    assert 0 < eng.results[rid_run].size < 20
    assert rid_pend in eng.results and 500 in eng.results
    assert rid_gone not in eng.results  # cancel publishes nothing
    assert eng.allocator.free_blocks == free0
    assert not eng.scheduler.running and not eng.scheduler.pending
    assert not eng.step()


def test_cancel_all_stops_a_live_staging_producer(models):
    _jc, tc, _params, sd = models
    eng = ServingEngine(tc, sd, serve=ServeConfig(**SERVE), device="cpu")
    reqs = [Request(id=i, prompt=np.arange(1, 9), max_new_tokens=3)
            for i in range(12)]
    eng.attach_source(iter(reqs), depth=2)
    eng.step()
    eng.cancel_all()
    assert eng._staging.closed
    surfaced = set(eng.results)
    assert not eng.step()
    assert set(eng.results) == surfaced
    assert not eng._staging_meta


def test_drain_gate_rejects_new_intake(models):
    _jc, tc, _params, sd = models
    eng = ServingEngine(tc, sd, serve=ServeConfig(**SERVE), device="cpu")
    rid = eng.submit(np.arange(1, 9), max_new_tokens=3)
    eng.accepting = False
    with pytest.raises(RuntimeError, match="draining"):
        eng.submit(np.arange(1, 9), max_new_tokens=3)
    with pytest.raises(RuntimeError, match="draining"):
        eng.attach_source(iter([]))
    assert eng.run()[rid].size == 3


def test_run_static_matches_jax(models):
    jc, tc, params, sd = models
    prompts = _prompts(7, 6)
    serve = dict(block_size=8, decode_tiers=(1, 2, 4), prefill_chunk=8)
    te = ServingEngine(tc, sd, serve=ServeConfig(**serve), device="cpu")
    je = JaxEngine(jc, params, serve=JaxServeConfig(**serve))
    gens = [4, 9, 2, 7, 5, 3]
    t_out = te.run_static([Request(id=i, prompt=p, max_new_tokens=g)
                           for i, (p, g) in enumerate(zip(prompts, gens))],
                          batch_size=4)
    j_out = je.run_static([JaxRequest(id=i, prompt=p, max_new_tokens=g)
                           for i, (p, g) in enumerate(zip(prompts, gens))],
                          batch_size=4)
    assert sorted(t_out) == sorted(j_out) == list(range(6))
    for i in range(6):
        np.testing.assert_array_equal(t_out[i], np.asarray(j_out[i]))
        assert len(t_out[i]) == gens[i]
    # the same streams as the continuous engine, inside its menu, with
    # every reservation released
    menu = ServingEngine(tc, sd, serve=ServeConfig(**serve), device="cpu")
    warmed = menu.warmup()
    assert warmed == len(menu._progs)
    assert set(te._progs) <= set(menu._progs)
    assert te.allocator.free_blocks == te.allocator.capacity
    ids = [te.submit(p, max_new_tokens=g) for p, g in zip(prompts, gens)]
    cont = te.run()
    for i, rid in enumerate(ids):
        np.testing.assert_array_equal(cont[rid], t_out[i])


PREFILL_SERVE = dict(block_size=8, token_budget=128, watermark=2,
                     prefill_tiers=(32,), decode_tiers=(1, 2),
                     prefill_chunk=8)


def test_prefill_role_menu_and_handoff_boundary(models):
    jc, tc, params, sd = models
    with pytest.raises(ValueError, match="role"):
        ServingEngine(tc, sd, serve=ServeConfig(**PREFILL_SERVE),
                      device="cpu", role="decode")
    eng = ServingEngine(tc, sd, serve=ServeConfig(**PREFILL_SERVE),
                        device="cpu", role="prefill")
    menu = len(eng.decode_tiers) * len(eng.chunk_tiers)
    je = JaxEngine(jc, params, serve=JaxServeConfig(**PREFILL_SERVE),
                   role="prefill")
    assert eng.warmup() == menu == eng.program_count == je.warmup()
    assert set(eng._progs) == set(je._progs)
    assert all(k[0] == "mixed" for k in eng._progs)
    full = ServingEngine(tc, sd, serve=ServeConfig(**PREFILL_SERVE),
                         device="cpu")
    assert full.warmup() > menu
    prompt = np.arange(1, 12, dtype=np.int32)
    rid = eng.submit(prompt, max_new_tokens=6)
    out = eng.run()
    jrid = je.submit(prompt, max_new_tokens=6)
    je.run()
    assert rid not in out and set(eng.handoffs) == {rid}
    stream, snap, _arr = eng.handoffs[rid]
    j_stream, j_snap, _ = je.handoffs[jrid]
    assert stream.size == prompt.size + 1
    np.testing.assert_array_equal(stream, j_stream)
    assert [int(h) for h in snap["hashes"]] == [int(h) for h in
                                                j_snap["hashes"]]
    assert len(snap["hashes"]) == 1  # 11 // 8
    assert not eng.scheduler.running and not eng.scheduler.pending
    assert eng.program_count == menu
    assert eng.allocator.peek_prefix(prompt, max_blocks=1) == 1
    # max_new_tokens=1 completes AT the boundary, locally
    rid1 = eng.submit(np.arange(1, 11, dtype=np.int32), max_new_tokens=1)
    out = eng.run()
    assert out[rid1].size == 1 and rid1 not in eng.handoffs


def test_prefill_role_never_runs_a_decode_step(models):
    _jc, tc, _params, sd = models
    eng = ServingEngine(tc, sd, serve=ServeConfig(**PREFILL_SERVE, spec=True),
                        device="cpu", role="prefill")
    eng.warmup()
    calls = []
    eng._decode_step = lambda *a, **k: calls.append(a)
    for p in _prompts(11, 6, lo=9, hi=30):
        eng.submit(p, max_new_tokens=5)
    eng.run()
    assert not calls and eng.spec_steps == 0
    assert len(eng.handoffs) == 6
    assert all(k[0] == "mixed" and k[3] is None for k in eng._progs)
