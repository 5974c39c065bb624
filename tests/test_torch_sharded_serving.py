"""Tensor-sharded serving in the port against the JAX engine's contract.

Mirrors ``tests/test_serving.py``'s sharded cases.  The port shards an
engine over a process set of ranks, one process each (here gloo over a
``file://`` store, ``spawn_ranks``; one worker set of two ranks for the
module), where the JAX engine runs one ``shard_map`` program:

* validation: the "must divide" message of both engines, the shard
  set's "need N devices" and explicit-list checks;
* the byte models: ``modeled_decode_read_bytes(shards=)``,
  ``pool_bytes(shards=)`` and ``modeled_serve_psum_bytes`` equal the
  JAX package's, and the per-rank read terms drop by the shard factor;
* shards 1 and 2 token-identical, through forced evictions and prefix
  hits, and equal to one-at-a-time decode of the JAX model
  (``ref_decode``), every step's tokens the same on both ranks
  (``check_agreement``); requests entering through ``attach_source``
  on the first rank alone; ``HVD_TPU_SERVE_SHARDS`` reaching the path;
* given the full tree, each rank keeps copies of its slices (its
  parameter storage is its own bytes), and ``shard_params`` refuses a
  tree that is not at the full shapes;
* the psum counter: ``shard_psum_bytes`` equals the
  ``SERVE_SHARD_PSUM_BYTES`` delta, and the all-reduces the steps ran
  (two a layer) stream exactly the modeled bytes;
* a speculative engine at shards = 2 in a scenario that forces
  evictions, prefix hits and rollbacks, equal to plain decode;
* snapshots: a shards = 2 export imports into a shards = 1 port engine
  and into the JAX engine and resumes token-identically, and a
  shards = 1 export imports into the shards = 2 engine.
"""

import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from horovod_tpu.models.transformer import Transformer as JaxTransformer
from horovod_tpu.models.transformer import TransformerConfig as JaxConfig
from horovod_tpu.serving import ServeConfig as JaxServeConfig
from horovod_tpu.serving import ServingEngine as JaxEngine
from horovod_tpu.serving import kv_cache as jkv
from horovod_tpu.ops import comm_model as jcomm
from horovod_tpu_torch.models import TransformerConfig, params_from_flax
from horovod_tpu_torch.models.convert import shard_params
from horovod_tpu_torch.ops import comm_model as tcomm
from horovod_tpu_torch.parallel import tensor_parallel as tparallel
from horovod_tpu_torch.serving import ServeConfig, ServingEngine
from horovod_tpu_torch.serving import kv_cache as tkv
from test_torch_collectives import spawn_ranks

VOCAB = 97
SHAPE = dict(vocab_size=VOCAB, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=8, max_seq_len=64)
EVICT = dict(block_size=4, num_blocks=25, token_budget=64, watermark=0,
             decode_tiers=(1, 2, 4), prefill_chunk=8)
LOAD = dict(block_size=8, num_blocks=0, token_budget=128, watermark=2,
            decode_tiers=(1, 2, 4), prefill_chunk=16)
SPEC = dict(block_size=4, num_blocks=17, token_budget=64, watermark=0,
            decode_tiers=(1, 2, 4), prefill_chunk=8, spec=True, spec_k=4)
SNAP = dict(block_size=4, num_blocks=25, token_budget=64, watermark=0,
            decode_tiers=(1, 2), prefill_chunk=8)
GEN, SPEC_GEN, SNAP_TOTAL = 14, 14, 18

WORKER = r"""
import os, pickle, sys
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch.metrics import instruments as instr
from horovod_tpu_torch.models import TransformerConfig
from horovod_tpu_torch.serving import Request, ServeConfig, ServingEngine


def allreduce_totals():
    return (instr.COLLECTIVES.labels("allreduce", "eager").get(),
            instr.COLLECTIVE_BYTES.labels("allreduce").get())

rank, world, store, out, given = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
hvd.init(device="cpu", rank=rank, size=world, init_method="file://" + store)
g = torch.load(given, weights_only=False)
cfg = TransformerConfig(dtype=torch.float32, **g["shape"])
sd = g["params"]
res, snaps = {}, {}


def engine(serve, shards, **kw):
    eng = ServingEngine(cfg, sd, serve=ServeConfig(shards=shards, **serve),
                        device="cpu", **kw)
    eng.check_agreement = True
    return eng


def serve_all(eng, prompts, gen):
    ids = [eng.submit(p, max_new_tokens=gen) for p in prompts]
    out = eng.run()
    return [out[i] for i in ids]


# shards 1 and 2 with evictions and prefix hits
for s in (1, world):
    eng = engine(g["evict"], s)
    for i, o in enumerate(serve_all(eng, g["evict_prompts"], g["gen"])):
        res[f"evict/{s}/{i}"] = o
    res[f"evict/{s}/counts"] = np.asarray(
        [eng.scheduler.evictions, eng.scheduler.prefix_hit_blocks])
# requests on the first rank alone, and through its staging
eng = engine(g["evict"], world)
if rank == 0:
    ids = [eng.submit(p, max_new_tokens=g["gen"]) for p in
           g["evict_prompts"][:2]]
    eng.attach_source(iter([Request(id=100 + i, prompt=p,
                                    max_new_tokens=g["gen"])
                            for i, p in enumerate(g["evict_prompts"][2:])]))
else:
    ids = [0, 1]
    eng.attach_source(iter(()))
out_ = eng.run()
for i, rid in enumerate(ids + [100 + j for j in
                               range(len(g["evict_prompts"]) - 2)]):
    res[f"lead/{i}"] = out_[rid]
# the psum counter under a templated load
eng = engine(g["load"], world)
assert eng.pool_bytes_per_shard * world == eng.pool_bytes
assert instr.SERVE_KV_BLOCKS_PER_SHARD.get() == eng.num_blocks
# each rank's weights own their memory: the cut leaves are copies, the
# replicated ones the given tensors
ps = list(eng.model.parameters())
given_ptrs = {t.untyped_storage().data_ptr() for t in sd.values()}
res["owned"] = np.asarray([
    sum({p.untyped_storage().data_ptr(): p.untyped_storage().nbytes()
         for p in ps}.values()),
    sum(p.numel() * p.element_size() for p in ps),
    sum(t.numel() * t.element_size() for t in sd.values()),
    sum(p.untyped_storage().data_ptr() in given_ptrs for p in ps)])
warmed = eng.warmup()
psum0 = instr.SERVE_SHARD_PSUM_BYTES.get()
red0 = allreduce_totals()
steps0 = eng.steps
load_out = serve_all(eng, g["load_prompts"], g["load_gen"])
res["psum"] = np.asarray([
    eng.shard_psum_bytes, instr.SERVE_SHARD_PSUM_BYTES.get() - psum0,
    *(a - b for a, b in zip(allreduce_totals(), red0)),
    eng.steps - steps0, warmed, eng.program_count])
for i, o in enumerate(load_out):
    res[f"load/{i}"] = o
inv = eng.decode_step_inventory(batch_tier=2)
res["inventory"] = np.asarray([len(inv["collectives"])] + [
    c["payload_bytes"] for c in inv["collectives"]])
# speculative, evictions forced
eng = engine(g["spec"], world)
spec_out = []
for wave in g["spec_waves"]:
    ids = [eng.submit(p, max_new_tokens=g["spec_gen"]) for p in wave]
    got = eng.run()
    spec_out += [got[i] for i in ids]
for i, o in enumerate(spec_out):
    res[f"spec/{i}"] = o
res["spec/counts"] = np.asarray([
    eng.scheduler.evictions, eng.scheduler.prefix_hit_blocks,
    eng.spec_accepted_tokens, eng.spec_rolled_back_tokens, eng.spec_steps])


def interrupt(eng, rid, n=8):
    while True:
        seq = next((s for s in eng.scheduler.running if s.req.id == rid),
                   None)
        if seq is not None and len(seq.generated) >= n:
            return
        assert eng.step()


def resume(dst, tokens, snap):
    prompt = g["snap_prompt"]
    gen = np.asarray(tokens[len(prompt):], np.int32)
    n = dst.import_kv(snap)
    rid = dst.submit(np.concatenate([prompt, gen]),
                     max_new_tokens=g["snap_total"] - gen.size)
    return n, np.concatenate([gen, dst.run()[rid]]), \
        dst.scheduler.prefix_hit_blocks


# a sharded export into an unsharded engine (and back)
src = engine(g["snap"], world)
rid = src.submit(g["snap_prompt"], max_new_tokens=g["snap_total"])
interrupt(src, rid)
tokens, snap, _arr = src.export_requests()[rid]
snaps["sharded"] = (tokens, snap)
n, res["resume/1"], hits = resume(engine(g["snap"], 1), tokens, snap)
res["resume/1/counts"] = np.asarray([n, len(snap["hashes"]), hits])
plain = engine(g["snap"], 1)
prid = plain.submit(g["snap_prompt"], max_new_tokens=g["snap_total"])
interrupt(plain, prid)
ptokens, psnap, _arr = plain.export_requests()[prid]
n, res["resume/2"], hits = resume(engine(g["snap"], world), ptokens, psnap)
res["resume/2/counts"] = np.asarray([n, len(psnap["hashes"]), hits])
# a set spanning hosts is refused (one rank a host here)
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.parallel import tensor_shard_mesh
basics._state.local_size = 1
try:
    tensor_shard_mesh("tp", world)
    res["hosts"] = np.asarray([0])
except ValueError as e:
    res["hosts"] = np.asarray([int("span hosts" in str(e))])
basics._state.local_size = world
# HVD_TPU_SERVE_SHARDS reaches the sharded path
os.environ["HVD_TPU_SERVE_SHARDS"] = str(world)
env = ServingEngine(cfg, sd, serve=ServeConfig.from_env(**g["load"]),
                    device="cpu")
res["env"] = np.asarray([env.shards, env.k_pool.shape[3]])
np.savez(out, **res)
with open(out + ".pkl", "wb") as f:
    pickle.dump(snaps, f)
hvd.shutdown()
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jc = JaxConfig(dtype=jnp.float32, **SHAPE)
    tc = TransformerConfig(dtype=torch.float32, **SHAPE)
    model = JaxTransformer(jc)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                        train=False)["params"]
    sd = params_from_flax(jax.tree.map(np.asarray, params), tc, device="cpu")
    return jc, tc, model, params, sd


_REF = {}


def ref_decode(model, params, prompt, n):
    """One-at-a-time full-context greedy decode of the JAX model, padded
    to max_seq_len so one compiled program serves every length."""
    key = id(params)
    if key not in _REF:
        _REF[key] = jax.jit(lambda x: model.apply(
            {"params": params}, x, train=False)[0])
    width = model.cfg.max_seq_len
    toks, out = list(np.asarray(prompt)), []
    for _ in range(n):
        x = np.zeros((1, width), np.int32)
        x[0, :len(toks)] = toks
        t = int(jnp.argmax(_REF[key](jnp.asarray(x))[len(toks) - 1]))
        toks.append(t)
        out.append(t)
    return np.asarray(out, np.int32)


def _template_prompts(rs, n, t_len, s_lo, s_hi):
    template = rs.randint(1, VOCAB, size=t_len).astype(np.int32)
    return [np.concatenate([template, rs.randint(
        1, VOCAB, size=rs.randint(s_lo, s_hi)).astype(np.int32)])
        for _ in range(n)]


def _spec_waves():
    rs = np.random.RandomState(1)
    template = rs.randint(1, VOCAB, size=11).astype(np.int32)

    def wave(n):
        return [np.concatenate([template, rs.randint(
            1, VOCAB, size=rs.randint(2, 5))]).astype(np.int32)
            for _ in range(n)]
    return [wave(3), wave(2)]


@pytest.fixture(scope="module")
def run(models, tmp_path_factory):
    """The world-2 worker set, spawned once: (rank 0's results, rank
    1's, the snapshots rank 0 exported, what the workers were given)."""
    _jc, _tc, _model, _params, sd = models
    tmp = tmp_path_factory.mktemp("sharded_serving")
    rs = np.random.RandomState(11)
    lrs = np.random.RandomState(12)
    templates = [lrs.randint(1, VOCAB, size=16).astype(np.int32)
                 for _ in range(2)]
    load = []
    for _ in range(8):
        suffix = lrs.randint(1, VOCAB, size=lrs.randint(3, 20)).astype(
            np.int32)
        load.append(np.concatenate([templates[lrs.randint(2)], suffix])
                    if lrs.random_sample() < 0.5 else suffix)
    given = dict(
        shape=SHAPE, params=sd, evict=EVICT, load=LOAD, spec=SPEC,
        snap=SNAP, gen=GEN, spec_gen=SPEC_GEN, snap_total=SNAP_TOTAL,
        load_gen=5,
        evict_prompts=_template_prompts(rs, 4, t_len=11, s_lo=2, s_hi=5),
        load_prompts=load, spec_waves=_spec_waves(),
        snap_prompt=np.random.RandomState(18).randint(
            1, VOCAB, size=13).astype(np.int32))
    torch.save(given, tmp / "given.pt")
    outs = spawn_ranks(WORKER, 2, tmp, tmp / "given.pt", timeout=240)
    with open(tmp / "rank0.npz.pkl", "rb") as f:
        snaps = pickle.load(f)
    return outs[0], outs[1], snaps, given


# -- validation and byte models (in process) ----------------------------------


def test_sharded_engine_validates(models):
    """The "must divide" check comes first, with the JAX engine's
    message (2 kv heads do not split 4 ways); the shard set needs the
    ranks and an explicit list of exactly ``shards`` of them."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import tensor_shard_mesh

    _jc, tc, _model, _params, sd = models
    with pytest.raises(ValueError, match="divide"):
        ServingEngine(tc, sd, serve=ServeConfig(
            block_size=8, num_blocks=0, decode_tiers=(1, 2), shards=4),
            device="cpu")
    with pytest.raises(ValueError, match="divide"):
        TransformerConfig(dtype=torch.float32, shard_axis=_Set(3), **SHAPE)
    was = hvd.is_initialized()
    hvd.init(device="cpu")
    try:
        with pytest.raises(ValueError, match="devices"):
            tensor_shard_mesh("tp", 99)
        with pytest.raises(ValueError, match="exactly"):
            tensor_shard_mesh("tp", 2, devices=[0])
        with pytest.raises(ValueError, match=">= 1"):
            tensor_shard_mesh("tp", 0)
        # a set of one is the unsharded engine
        one = tensor_shard_mesh("tp", 1)
        eng = ServingEngine(tc, sd, serve=ServeConfig(
            block_size=8, decode_tiers=(1, 2)), device="cpu", mesh=one)
        assert eng.shards == 1 and eng.mesh is None
    finally:
        if not was:
            hvd.shutdown()


class _Set:
    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


def test_modeled_decode_read_bytes_shards_pin():
    """Per-rank modeled reads at shard factors 1/2/4 equal the JAX
    package's and the kernel term exactly, and drop by the factor."""
    kw = dict(block_size=16, num_heads=8, num_kv_heads=4, head_dim=64,
              num_layers=4, dtype_bytes=2, max_seq_len=2048)
    base = tkv.modeled_decode_read_bytes(256, **kw)
    for s in (1, 2, 4):
        m = tkv.modeled_decode_read_bytes(256, shards=s, **kw)
        assert m == jkv.modeled_decode_read_bytes(256, shards=s, **kw)
        kernel_term = (kw["num_layers"] * m["pages_read"] * 2
                       * kw["block_size"] * (kw["num_kv_heads"] // s)
                       * kw["head_dim"] * kw["dtype_bytes"])
        assert m["paged_bytes"] == kernel_term == base["paged_bytes"] // s
        assert m["gathered_bytes"] == base["gathered_bytes"] // s
        assert m["pages_read"] == base["pages_read"]
        assert m["full_bytes"] == base["full_bytes"]
        assert tkv.pool_bytes(2, 9, 4, 4, 8, torch.bfloat16, shards=s) == \
            jkv.pool_bytes(2, 9, 4, 4, 8, jnp.bfloat16, shards=s)
    with pytest.raises(ValueError, match="divide"):
        tkv.modeled_decode_read_bytes(256, shards=3, **kw)
    with pytest.raises(ValueError, match="divide"):
        tkv.pool_bytes(2, 9, 4, 4, 8, torch.float32, shards=3)


@pytest.mark.parametrize("args", [(1, 1, 16, 2, 2, "float32"),
                                  (8, 1, 4096, 32, 2, "bfloat16"),
                                  (4, 16, 64, 3, 4, "float32"),
                                  (2, 8, 32, 2, 1, "float32")])
def test_modeled_serve_psum_bytes_matches_jax(args):
    assert tcomm.modeled_serve_psum_bytes(*args[:5], dtype=args[5]) == \
        jcomm.modeled_serve_psum_bytes(*args[:5], dtype=args[5])
    assert tcomm.modeled_serve_psum_bytes(
        *args[:5], dtype=getattr(torch, args[5])) == \
        jcomm.modeled_serve_psum_bytes(*args[:5], dtype=args[5])


def test_shard_psum_instrument_matches_reference():
    from horovod_tpu.metrics import instruments as jinstr
    from horovod_tpu_torch.metrics import instruments as tinstr

    for name in ("SERVE_SHARD_PSUM_BYTES", "SERVE_KV_BLOCKS_PER_SHARD"):
        t, j = getattr(tinstr, name), getattr(jinstr, name)
        assert type(t).__name__ == type(j).__name__
        assert (t.name, t.documentation, tuple(t.labelnames)) == \
            (j.name, j.documentation, tuple(j.labelnames))


# -- the world-2 engines -----------------------------------------------------


def test_sharded_decode_token_identical_with_evictions(models, run):
    """Shards 1 and 2 emit the same tokens through prefix hits, chunked
    prefill and forced LIFO evictions, on both ranks, equal to
    one-at-a-time decode of the JAX model."""
    _jc, _tc, model, params, _sd = models
    r0, r1, _snaps, given = run
    for r in (r0, r1):
        for s in (1, 2):
            ev, hits = r[f"evict/{s}/counts"]
            assert ev > 0, "pool sized to force evictions"
            assert hits > 0, "templates must hit"
    for i, prompt in enumerate(given["evict_prompts"]):
        want = ref_decode(model, params, prompt, GEN)
        for r in (r0, r1):
            np.testing.assert_array_equal(r[f"evict/2/{i}"],
                                          r[f"evict/1/{i}"])
            np.testing.assert_array_equal(r[f"evict/2/{i}"], want,
                                          err_msg=f"request {i}")
            # entered on the first rank alone (two through its staging)
            np.testing.assert_array_equal(r[f"lead/{i}"], want)


def test_sharded_psum_counter_matches_model(models, run):
    """``shard_psum_bytes`` equals the instrument's delta; the steps ran
    two all-reduces a layer, and their payloads' ring stream is exactly
    the modeled bytes; the menu stays the warmed one; the decode step's
    inventory lists its all-reduces at the modeled payload."""
    _jc, tc, model, params, _sd = models
    r0, r1, _snaps, given = run
    for r in (r0, r1):
        booked, delta, calls, payload, steps, warmed, progs = r["psum"]
        assert booked > 0 and booked == delta
        assert calls == 2 * tc.num_layers * steps
        assert payload * 2 * (2 - 1) // 2 == booked
        assert progs == warmed
        m = tcomm.modeled_serve_psum_bytes(2, 1, tc.d_model, tc.num_layers,
                                           2, "float32")
        inv = r["inventory"]
        assert inv[0] == m["psum_count"]
        assert list(inv[1:]) == [m["payload_bytes"]] * m["psum_count"]
    for i in (0, 3, 7):
        prompt = given["load_prompts"][i]
        np.testing.assert_array_equal(
            r0[f"load/{i}"], ref_decode(model, params, prompt, 5))


def test_sharded_engine_owns_its_slices(models, run):
    """Given the full tree, a shards = 2 engine keeps copies of its
    slices, not views of the full leaves: each rank's parameter storage
    is its own parameters' bytes, under the full tree's, and only the
    replicated leaves are the given tensors."""
    _jc, tc, _model, _params, sd = models
    replicated = sum(dim is None for dim in
                     tparallel.transformer_shard_specs(sd).values())
    for r in run[:2]:
        storage, own, full, shared = r["owned"]
        assert storage == own < full
        assert shared == replicated


def test_shard_params_copies_and_checks_shapes(models):
    """``shard_params`` cuts each sharded leaf into a contiguous copy
    (``shard_map``'s slice), passes replicated leaves through, and
    refuses a tree that is not at the full shapes (one sliced before)."""
    _jc, tc, _model, _params, sd = models
    specs = tparallel.transformer_shard_specs(sd)
    cut = shard_params(sd, tc, 1, 2)
    for key, dim in specs.items():
        if dim is None:
            assert cut[key] is sd[key]
            continue
        want = tparallel.shard_slice(sd[key], dim, 1, 2)
        assert cut[key].is_contiguous()
        assert cut[key].untyped_storage().nbytes() == \
            want.numel() * want.element_size()
        assert torch.equal(cut[key], want)
    with pytest.raises(ValueError, match="full tree"):
        shard_params(cut, tc, 1, 2)


def test_sharded_speculative_with_evictions(models, run):
    """A speculative engine at shards = 2: evictions, prefix hits,
    accepted drafts and rollbacks all in the loop, every stream equal
    to plain decode."""
    _jc, _tc, model, params, _sd = models
    r0, r1, _snaps, _given = run
    prompts = [p for w in _spec_waves() for p in w]
    for r in (r0, r1):
        ev, hits, accepted, rolled, steps = r["spec/counts"]
        assert ev > 0 and hits > 0 and accepted > 0 and rolled > 0
        assert steps > 0
        for i, p in enumerate(prompts):
            np.testing.assert_array_equal(
                r[f"spec/{i}"], ref_decode(model, params, p, SPEC_GEN),
                err_msg=f"request {i}")


def test_sharded_snapshots_cross_shard_factors_and_packages(models, run):
    """A shards = 2 export resumes token-identically in a shards = 1
    port engine and in the JAX engine; a shards = 1 export resumes in
    the shards = 2 engine."""
    jc, _tc, model, params, _sd = models
    r0, r1, snaps, given = run
    prompt = given["snap_prompt"]
    want = ref_decode(model, params, prompt, SNAP_TOTAL)
    for r in (r0, r1):
        for key in ("resume/1", "resume/2"):
            np.testing.assert_array_equal(r[key], want, err_msg=key)
            n, hashes, hits = r[key + "/counts"]
            assert n == hashes and hits >= hashes - 1
    tokens, snap = snaps["sharded"]
    assert np.asarray(snap["pages"][0][0]).shape == (
        SHAPE["num_layers"], SNAP["block_size"], SHAPE["num_kv_heads"],
        SHAPE["head_dim"])
    dst = JaxEngine(jc, params, serve=JaxServeConfig(**SNAP))
    gen = np.asarray(tokens[len(prompt):], np.int32)
    assert dst.import_kv(snap) == len(snap["hashes"])
    rid = dst.submit(np.concatenate([prompt, gen]),
                     max_new_tokens=SNAP_TOTAL - gen.size)
    out = dst.run()
    assert dst.scheduler.prefix_hit_blocks >= len(snap["hashes"]) - 1
    np.testing.assert_array_equal(np.concatenate([gen, out[rid]]), want)


def test_env_shards_reach_the_sharded_path(run):
    r0, r1, _snaps, _given = run
    for r in (r0, r1):
        assert list(r["env"]) == [2, SHAPE["num_kv_heads"] // 2]


def test_shard_set_must_stay_on_one_host(run):
    """The reference's DCN-exclusion rule as one host: a set whose ranks
    sit on two hosts is refused before any group is made."""
    r0, r1, _snaps, _given = run
    assert r0["hosts"][0] == 1 and r1["hosts"][0] == 1
