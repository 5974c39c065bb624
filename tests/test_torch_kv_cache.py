"""The port's paged KV cache against the JAX package's.

* ``BlockAllocator`` — scripted traces (alloc / free / register /
  match_prefix / peek_prefix / truncate_tail / clear_cache, including
  LRU reclaim and a hash collision) give identical results and leave
  identical allocator state.
* ``PagedKVState`` — ``write_decode`` / ``write_chunk`` / ``gather`` on
  the same pools, tables and lengths are bit-equal (the port writes its
  pools in place, the JAX state returns new ones).
* ``pool_bytes`` / ``modeled_decode_read_bytes`` are equal.
"""

import itertools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from horovod_tpu.serving import kv_cache as jkv
from horovod_tpu_torch.serving import kv_cache as tkv


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is enough, and the suite runs
    several workers side by side on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(alloc):
    return (list(alloc._free), list(alloc._lru), list(alloc._ref),
            dict(alloc._index), dict(alloc._meta), alloc.peak_occupancy,
            alloc.free_blocks, alloc.cached_blocks)


def _trace(alloc):
    """A fixed script over the allocator API; returns every result."""
    out = []
    toks = list(range(1, 41))
    a = alloc.alloc(3)
    out.append(a)
    h0 = alloc.register(a[0], tkv.PREFIX_HASH_ROOT, toks[0:4])
    h1 = alloc.register(a[1], h0, toks[4:8])
    out += [alloc.match_prefix(toks, max_blocks=2),
            alloc.peek_prefix(toks), alloc.peek_prefix(toks, max_blocks=1)]
    alloc.free(a)  # a[0], a[1] still referenced by the match
    out.append(_state(alloc)[:3])
    alloc.free(out[1][0])  # cached blocks park on the LRU
    out.append(alloc.alloc(4))  # drains the free list before reclaiming
    out.append(alloc.match_prefix(toks))  # hits parked blocks
    big = alloc.alloc(alloc.free_blocks)  # reclaims whatever is parked
    out.append(big)
    out.append(alloc.alloc(1))  # dry pool
    alloc.free(big)
    seq = alloc.alloc(3)
    kept = alloc.truncate_tail(seq, 4)
    out += [seq, kept, alloc.truncate_tail(kept, 9)]
    out.append(alloc.register(kept[0], 999, toks[8:12]))
    out.append(alloc.occupancy())
    with pytest.raises(ValueError):
        alloc.free([0])
    alloc.clear_cache()
    out.append(_state(alloc)[:3])
    out.append(h1)
    return out


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("collide", [False, True])
def test_allocator_traces_identical(prefix_cache, collide):
    j = jkv.BlockAllocator(12, block_size=4, prefix_cache=prefix_cache)
    t = tkv.BlockAllocator(12, block_size=4, prefix_cache=prefix_cache)
    if collide:  # every hash collides: the full compare must reject
        j.hash_fn = t.hash_fn = lambda parent, toks: 7
    assert _trace(t) == _trace(j)
    assert _state(t) == _state(j)


def test_allocator_validation_matches():
    for bad in ((1, 4), (4, 0)):
        with pytest.raises(ValueError):
            jkv.BlockAllocator(*bad)
        with pytest.raises(ValueError):
            tkv.BlockAllocator(*bad)
    t = tkv.BlockAllocator(4, 2)
    with pytest.raises(ValueError, match="exactly one full block"):
        t.register(t.alloc(1)[0], 0, [1, 2, 3])
    assert tkv.blocks_for(17, 16) == jkv.blocks_for(17, 16) == 2


def _paged_pair(mode, window_case):
    rs = np.random.RandomState(7)
    L, N, bs, hkv, d, B, mb = 2, 12, 4, 2, 8, 3, 5
    k = rs.randn(L, N, bs, hkv, d).astype(np.float32)
    v = rs.randn(L, N, bs, hkv, d).astype(np.float32)
    tables = np.array([[3, 7, 1, 0, 0], [2, 4, 6, 9, 11], [5, 0, 0, 0, 0]],
                      np.int32)
    lens = np.array([9, 18, 2], np.int32) if not window_case else \
        np.array([11, 19, 0], np.int32)
    chunk_lens = np.array([3, 1, 2], np.int32)
    c = 4
    k_new = rs.randn(B, c if mode == "chunk" else 1, hkv, d).astype(
        np.float32)
    v_new = rs.randn(*k_new.shape).astype(np.float32)
    js = jkv.PagedKVState(
        k=jnp.asarray(k), v=jnp.asarray(v), tables=jnp.asarray(tables),
        lens=jnp.asarray(lens), mode=mode,
        chunk_lens=jnp.asarray(chunk_lens) if mode == "chunk" else None,
        gather_pages=3 if not window_case else None)
    ts = tkv.PagedKVState(
        k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
        tables=torch.from_numpy(tables).long(),
        lens=torch.from_numpy(lens), mode=mode,
        chunk_lens=torch.from_numpy(chunk_lens) if mode == "chunk" else None,
        gather_pages=3 if not window_case else None)
    return js, ts, k_new, v_new


@pytest.mark.parametrize("mode,window_case", list(itertools.product(
    ("decode", "chunk"), (False, True))))
def test_paged_write_and_gather_bit_equal(mode, window_case):
    js, ts, k_new, v_new = _paged_pair(mode, window_case)
    write = "write_chunk" if mode == "chunk" else "write_decode"
    for layer in (0, 1):
        getattr(js, write)(layer, jnp.asarray(k_new), jnp.asarray(v_new))
        getattr(ts, write)(layer, torch.from_numpy(k_new),
                           torch.from_numpy(v_new))
    # the trash block takes pad-column writes in an unspecified order;
    # every real block must match bit for bit
    np.testing.assert_array_equal(ts.k.numpy()[:, 1:],
                                  np.asarray(js.k)[:, 1:])
    np.testing.assert_array_equal(ts.v.numpy()[:, 1:],
                                  np.asarray(js.v)[:, 1:])
    window = 6 if window_case else None
    span = k_new.shape[1]
    for layer in (0, 1):
        gk_j, gv_j, st_j = js.gather(layer, window=window, q_span=span)
        gk_t, gv_t, st_t = ts.gather(layer, window=window, q_span=span)
        np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
        np.testing.assert_array_equal(gk_t.numpy().shape, gk_j.shape)
        real = np.asarray(jnp.repeat(
            _gathered_blocks(js, window, span) != 0, 4, axis=1))
        np.testing.assert_array_equal(gk_t.numpy()[real],
                                      np.asarray(gk_j)[real])
        np.testing.assert_array_equal(gv_t.numpy()[real],
                                      np.asarray(gv_j)[real])


def _gathered_blocks(js, window, span):
    """The block ids each gathered page came from (JAX's rule)."""
    if window is None:
        return js.tables[:, :js.gather_pages]
    bs, mb = js.block_size, js.max_blocks
    n_win = min(mb, (window + span - 1) // bs + 2)
    first = jnp.clip((js.lens + 1 - window) // bs, 0, mb - n_win)
    idx = first[:, None] + jnp.arange(n_win)[None]
    return jnp.take_along_axis(js.tables, idx, axis=1)


def test_pool_geometry_models_equal():
    for dt_j, dt_t in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float32, torch.float32)):
        for args in ((32, 4097, 16, 8, 128), (2, 17, 4, 2, 16)):
            assert tkv.pool_bytes(*args, dt_t) == jkv.pool_bytes(*args, dt_j)
            k, v = tkv.make_pools(*args[:1], 3, *args[2:], dt_t,
                                  device="cpu")
            assert tkv.pool_bytes(args[0], 3, *args[2:], dt_t) == \
                k.nbytes + v.nbytes
    for ctx, window, gp in itertools.product(
            (1, 15, 16, 700, 4096), (None, 7, 512), (None, 4, 64)):
        kw = dict(block_size=16, num_heads=32, num_kv_heads=8,
                  head_dim=128, num_layers=32, window=window,
                  max_seq_len=8192, gather_pages=gp)
        assert tkv.modeled_decode_read_bytes(ctx, **kw) == \
            jkv.modeled_decode_read_bytes(ctx, **kw)
