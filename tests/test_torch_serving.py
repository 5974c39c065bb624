"""The port's serving engine against the JAX package's.

The same bridged weights serve the same requests through
``horovod_tpu.serving.ServingEngine`` and through the port's
``ServingEngine(device="cpu")`` (whose attention runs the kernel's plain
version).  Held to three things:

* the greedy token streams are identical, and each equals one-at-a-time
  cache-free decode of the JAX model (``ref_decode``);
* across evictions, chunked prefill, prefix cache on and off, and a
  windowed GQA config;
* the scheduler's counters (evictions, prefix hit blocks, prefill tokens
  computed) are equal.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.models.transformer import Transformer as JaxTransformer
from horovod_tpu.models.transformer import TransformerConfig as JaxConfig
from horovod_tpu.serving import ServeConfig as JaxServeConfig
from horovod_tpu.serving import ServingEngine as JaxEngine
from horovod_tpu_torch.models import TransformerConfig, params_from_flax
from horovod_tpu_torch.serving import ServeConfig, ServingEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is enough, and the suite runs
    several workers side by side on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VOCAB = 97


def _configs(window=None):
    shape = dict(vocab_size=VOCAB, num_layers=2, num_heads=4, num_kv_heads=2,
                 head_dim=8, max_seq_len=64, window=window)
    return (JaxConfig(dtype=jnp.float32, **shape),
            TransformerConfig(dtype=torch.float32, **shape))


@pytest.fixture(scope="module")
def models():
    out = {}
    for window in (None, 6):
        jc, tc = _configs(window)
        model = JaxTransformer(jc)
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                            train=False)["params"]
        sd = params_from_flax(jax.tree.map(np.asarray, params), tc,
                              device="cpu")
        out[window] = (jc, tc, model, params, sd)
    return out


_REF_FNS = {}


def ref_decode(model, params, prompt, n):
    """One-at-a-time full-context greedy decode of the JAX model (no
    cache at all).  Each step runs the whole context, padded to
    max_seq_len so one compiled program serves every length; the model
    is causal, so the pad tail never reaches the logits read at the
    last real position."""
    key = (id(model), id(params))
    if key not in _REF_FNS:
        _REF_FNS[key] = jax.jit(lambda x: model.apply(
            {"params": params}, x, train=False)[0])
    apply = _REF_FNS[key]
    width = model.cfg.max_seq_len
    toks = list(np.asarray(prompt))
    out = []
    for _ in range(n):
        row = np.zeros((1, width), np.int32)
        row[0, :len(toks)] = toks
        logits = apply(jnp.asarray(row))[len(toks) - 1]
        t = int(jnp.argmax(logits.astype(jnp.float32)))
        toks.append(t)
        out.append(t)
    return np.asarray(out, np.int32)


def _serve(engine, waves, gen):
    """Submit each wave, run it to completion; returns streams by
    submission order."""
    ids = []
    for wave in waves:
        ids += [engine.submit(p, max_new_tokens=gen) for p in wave]
        out = engine.run()
    return [np.asarray(out[i]) for i in ids]


def _counters(engine):
    return (engine.scheduler.evictions, engine.scheduler.prefix_hit_blocks,
            engine.prefill_tokens_computed)


def _both(models, window, serve_kw, waves, gen, check_ref=True):
    jc, tc, model, params, sd = models[window]
    je = JaxEngine(jc, params, serve=JaxServeConfig(**serve_kw))
    te = ServingEngine(tc, sd, serve=ServeConfig(**serve_kw), device="cpu")
    j_out = _serve(je, waves, gen)
    t_out = _serve(te, waves, gen)
    for i, (a, b) in enumerate(zip(t_out, j_out)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    assert _counters(te) == _counters(je)
    if check_ref:
        prompts = [p for wave in waves for p in wave]
        for i, p in enumerate(prompts):
            np.testing.assert_array_equal(
                t_out[i], ref_decode(model, params, p, gen),
                err_msg=f"request {i} vs ref_decode")
    return t_out, te


def _prompts(seed, n, lo, hi, template=None):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        p = rs.randint(1, VOCAB, size=rs.randint(lo, hi)).astype(np.int32)
        out.append(p if template is None else np.concatenate([template, p]))
    return out


def test_continuous_batching_matches_jax_and_oracle(models):
    prompts = _prompts(0, 4, 3, 20)
    _both(models, None, dict(block_size=8, token_budget=128, watermark=2,
                             decode_tiers=(1, 2)), [prompts], 8)


def test_evictions_match_jax_and_oracle(models):
    """16 allocatable blocks of 4 cannot hold two sequences growing to
    ~36 tokens each: growth evicts (LIFO recompute), freed blocks are
    reused, and the streams stay pinned."""
    prompts = _prompts(1, 3, 10, 14)
    _, te = _both(models, None, dict(block_size=4, num_blocks=17,
                                     token_budget=64, watermark=0,
                                     decode_tiers=(1, 2)), [prompts], 24)
    assert te.scheduler.evictions > 0, "pool was sized to force evictions"


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_chunked_prefill_and_prefix_cache_match_jax(models, prefix_cache):
    """Prompts share a 12-token template; a second wave arrives after
    the first has published its blocks, so the cache-on run hits.
    Streams are bit-identical with the cache on and off."""
    template = np.arange(5, 17, dtype=np.int32)
    waves = [_prompts(2, 3, 2, 14, template), _prompts(3, 2, 2, 9, template)]
    serve = dict(block_size=4, token_budget=16, watermark=1,
                 decode_tiers=(1, 2), prefill_chunk=8,
                 prefix_cache=prefix_cache)
    out, te = _both(models, None, serve, waves, 6,
                    check_ref=not prefix_cache)
    if prefix_cache:
        assert te.scheduler.prefix_hit_blocks > 0
        out_off, off = _both(models, None, dict(serve, prefix_cache=False),
                             waves, 6, check_ref=False)
        assert off.prefill_tokens_computed > te.prefill_tokens_computed
        for a, b in zip(out, out_off):
            np.testing.assert_array_equal(a, b)


def test_windowed_gqa_config_matches_jax_and_oracle(models):
    prompts = _prompts(4, 3, 8, 20)
    _both(models, 6, dict(block_size=4, token_budget=32, watermark=1,
                          decode_tiers=(1, 2), prefill_chunk=8),
          [prompts], 10)


def test_engine_validates_like_jax(models):
    _, tc, _, _, sd = models[None]
    eng = ServingEngine(tc, sd, serve=ServeConfig(block_size=8,
                                                  decode_tiers=(1, 2)),
                        device="cpu")
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros((0,), np.int32), max_new_tokens=4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.ones((4,), np.int32), max_new_tokens=0)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(np.ones((60,), np.int32), max_new_tokens=10)
    for field in ({"shards": 2}, {"spec": True}):
        with pytest.raises(NotImplementedError, match="not ported"):
            ServingEngine(tc, sd, serve=ServeConfig(**field), device="cpu")
    assert eng.warmup() == 2  # one mixed and one decode shape
    assert eng.prefill_tiers == (32, 64)
