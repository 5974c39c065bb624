"""The port's speculative decoding against the JAX package's.

* The drafters and ``accept_greedy`` give the reference's outputs on its
  edge cases and on seeded random streams.
* ``spec_k`` validation and the static verify width ``spec_w``.
* A speculative engine under a scenario that forces evictions, prefix
  hits, accepted drafts and rolled-back drafts (each asserted on the
  port's run) emits the JAX speculative engine's streams, which equal
  one-at-a-time cache-free decode (``ref_decode``).
* ``submit(spec_k=0)`` opts one request out; the cache lags the stream
  by exactly one after every verify step and re-publishes its blocks.
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
from horovod_tpu.serving import speculative as jspec
from horovod_tpu_torch.models import TransformerConfig, params_from_flax
from horovod_tpu_torch.serving import ServeConfig, ServingEngine, blocks_for
from horovod_tpu_torch.serving import speculative as tspec

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
    return jc, tc, model, params, sd


_REF_FNS = {}


def ref_decode(model, params, prompt, n):
    """One-at-a-time full-context greedy decode of the JAX model, each
    step over the context padded to max_seq_len (one program; the model
    is causal, so the pad tail never reaches the last real logits)."""
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
        t = int(jnp.argmax(apply(jnp.asarray(row))[len(toks) - 1]
                           .astype(jnp.float32)))
        toks.append(t)
        out.append(t)
    return np.asarray(out, np.int32)


# -- drafters and the acceptance rule ----------------------------------------

_LOOKUP_CASES = [
    ([1, 2, 3, 9, 8, 1, 2, 3], 2), ([1, 2, 3, 9, 8, 1, 2, 3], 5),
    ([1, 2, 5, 1, 2, 7, 1, 2], 1), ([1, 2, 8, 8, 8, 1, 2, 9, 1, 2], 2),
    ([1, 2, 8, 8, 8, 1, 2, 9, 1, 2], 4), ([1, 2, 3, 4, 5], 4), ([7], 4),
    ([3, 3, 3, 3], 2), ([1, 2, 3], 0),
]


@pytest.mark.parametrize("stream,k", _LOOKUP_CASES)
def test_prompt_lookup_drafter_matches_jax_edge_cases(stream, k):
    got = tspec.PromptLookupDrafter(max_ngram=3, min_ngram=1).draft(stream, k)
    want = jspec.PromptLookupDrafter(max_ngram=3, min_ngram=1).draft(stream, k)
    assert got == want


def test_drafters_match_jax_on_random_streams():
    """Seeded streams over small alphabets (so n-grams recur), every
    n-gram window and k in 1..5."""
    rs = np.random.RandomState(0)
    for _ in range(200):
        n = int(rs.randint(1, 40))
        stream = [int(t) for t in rs.randint(0, int(rs.randint(2, 6)),
                                             size=n)]
        k = int(rs.randint(1, 6))
        lo = int(rs.randint(1, 3))
        hi = lo + int(rs.randint(0, 3))
        assert tspec.PromptLookupDrafter(hi, lo).draft(stream, k) == \
            jspec.PromptLookupDrafter(hi, lo).draft(stream, k), (stream, k)
        draft = [int(t) for t in rs.randint(0, 3, size=k)]
        verify = [int(t) for t in rs.randint(0, 3, size=k + 1)]
        assert tspec.accept_greedy(draft, verify) == \
            jspec.accept_greedy(draft, verify)
    with pytest.raises(ValueError, match="min_ngram"):
        tspec.PromptLookupDrafter(max_ngram=1, min_ngram=2)


def test_model_drafter_registry_and_accept_edges():
    d = tspec.ModelDrafter(lambda toks, k: [11, 12, 13, 14, 15])
    assert d.draft([1, 2, 3], 3) == [11, 12, 13]
    assert isinstance(tspec.make_drafter("prompt_lookup"),
                      tspec.PromptLookupDrafter)
    assert isinstance(d, tspec.Drafter)
    with pytest.raises(ValueError, match="prompt_lookup"):
        tspec.make_drafter("no_such_drafter")
    for draft, verify in (([1, 2, 3], [1, 2, 3, 7]), ([1, 9, 3], [1, 2, 3, 7]),
                          ([9], [5, 6]), ([], [4])):
        assert tspec.accept_greedy(draft, verify) == \
            jspec.accept_greedy(draft, verify)


def test_spec_engine_validates_like_jax(models):
    jc, tc, _model, params, sd = models
    serve = dict(block_size=8, decode_tiers=(1, 2))
    with pytest.raises(ValueError, match="spec_k must be >= 1"):
        ServingEngine(tc, sd, serve=ServeConfig(spec=True, spec_k=0,
                                                **serve), device="cpu")
    for k in (1, 3, 4, 7):
        te = ServingEngine(tc, sd, serve=ServeConfig(spec=True, spec_k=k,
                                                     **serve), device="cpu")
        je = JaxEngine(jc, params, serve=JaxServeConfig(spec=True, spec_k=k,
                                                        **serve))
        assert te.spec_w == je.spec_w == 1 << k.bit_length()
    with pytest.raises(ValueError, match="spec_k must be >= 0"):
        te.submit(np.arange(1, 5), max_new_tokens=2, spec_k=-1)
    # a prefill-role engine never drafts
    pre = ServingEngine(tc, sd, serve=ServeConfig(spec=True, **serve),
                        device="cpu", role="prefill")
    assert pre.spec_w == 0


# -- the speculative oracle --------------------------------------------------

def _spec_serve(**kw):
    return dict(block_size=4, num_blocks=17, token_budget=64, watermark=0,
                decode_tiers=(1, 2, 4), prefill_chunk=8, spec=True, spec_k=4,
                **kw)


def _spec_waves():
    """Two waves over one 11-token template: the second arrives after
    the first has published its blocks (prefix hits); 16 allocatable
    blocks of 4 cannot hold three sequences growing to ~28 tokens plus
    their speculative tails (evictions)."""
    rs = np.random.RandomState(1)
    template = rs.randint(1, VOCAB, size=11).astype(np.int32)

    def wave(n):
        return [np.concatenate([template, rs.randint(
            1, VOCAB, size=rs.randint(2, 5))]).astype(np.int32)
            for _ in range(n)]
    return [wave(3), wave(2)]


def _serve_waves(eng, waves, gen):
    ids = []
    for w in waves:
        ids += [eng.submit(p, max_new_tokens=gen) for p in w]
        out = eng.run()
    return [np.asarray(out[i]) for i in ids]


def test_speculative_oracle_with_evictions_prefix_hits_and_rollback(models):
    jc, tc, model, params, sd = models
    waves, gen = _spec_waves(), 14
    te = ServingEngine(tc, sd, serve=ServeConfig(**_spec_serve()),
                       device="cpu")
    t_out = _serve_waves(te, waves, gen)
    assert te.scheduler.evictions > 0, "pool sized to force evictions"
    assert te.scheduler.prefix_hit_blocks > 0, "the template must hit"
    assert te.spec_accepted_tokens > 0, "drafts must land"
    assert te.spec_rolled_back_tokens > 0, "rollback must be in the loop"
    assert te.spec_steps > 0
    je = JaxEngine(jc, params, serve=JaxServeConfig(**_spec_serve()))
    j_out = _serve_waves(je, waves, gen)
    for i, (a, b) in enumerate(zip(t_out, j_out)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i} vs JAX")
    assert (te.scheduler.evictions, te.scheduler.prefix_hit_blocks,
            te.spec_drafted_tokens, te.spec_accepted_tokens,
            te.spec_rolled_back_tokens, te.spec_steps) == (
        je.scheduler.evictions, je.scheduler.prefix_hit_blocks,
        je.spec_drafted_tokens, je.spec_accepted_tokens,
        je.spec_rolled_back_tokens, je.spec_steps)
    prompts = [p for w in waves for p in w]
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(
            t_out[i], ref_decode(model, params, p, gen),
            err_msg=f"request {i} vs ref_decode")
    # every step ran inside the warmup menu, which is the JAX engine's
    menu = ServingEngine(tc, sd, serve=ServeConfig(**_spec_serve()),
                         device="cpu")
    assert menu.warmup() == len(menu._progs)
    assert set(te._progs) <= set(menu._progs)
    assert set(te._progs) == set(je._progs)


def test_spec_k_per_request_opt_out(models):
    _jc, tc, model, params, sd = models
    eng = ServingEngine(tc, sd, serve=ServeConfig(
        block_size=8, token_budget=64, watermark=2, decode_tiers=(1,),
        prefill_tiers=(16,), spec=True, spec_k=4), device="cpu")
    prompt = np.asarray([3, 4, 3, 4, 3, 4, 3, 4], np.int32)
    rid = eng.submit(prompt, max_new_tokens=10, spec_k=0)
    eng.run()
    assert eng.spec_drafted_tokens == 0 and eng.spec_steps == 0
    np.testing.assert_array_equal(eng.results[rid],
                                  ref_decode(model, params, prompt, 10))
    rid2 = eng.submit(prompt, max_new_tokens=10)  # the engine's k
    eng.run()
    assert eng.spec_drafted_tokens > 0
    np.testing.assert_array_equal(eng.results[rid2], eng.results[rid])


def test_spec_cache_lags_one_and_republishes(models):
    """After every verify step the cache holds exactly length - 1 tokens
    and the table no speculative tail; the published blocks re-admit a
    repeat prompt with a bit-identical stream."""
    _jc, tc, model, params, sd = models
    eng = ServingEngine(tc, sd, serve=ServeConfig(
        block_size=4, token_budget=64, watermark=2, decode_tiers=(1, 2),
        spec=True, spec_k=4), device="cpu")
    prompt = np.asarray([5, 6, 7, 5, 6, 7, 5, 6], np.int32)  # draftable
    rid = eng.submit(prompt, max_new_tokens=12)
    while eng.step():
        for s in eng.scheduler.running:
            if s.in_decode:
                assert s.tokens_in_cache == s.length - 1
                assert blocks_for(s.length, 4) <= len(s.blocks) \
                    <= blocks_for(s.length + 1, 4), \
                    "stale speculative tail in the block table"
    out1 = eng.results[rid]
    assert eng.spec_drafted_tokens > 0
    hits0 = eng.scheduler.prefix_hit_blocks
    rid2 = eng.submit(prompt, max_new_tokens=12)
    eng.run()
    assert eng.scheduler.prefix_hit_blocks > hits0
    np.testing.assert_array_equal(eng.results[rid2], out1)
    np.testing.assert_array_equal(out1, ref_decode(model, params, prompt, 12))
