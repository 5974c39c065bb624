"""The port's paged decode attention (``flash_decode_paged``) on the CPU.

* Against the JAX package's own decode path on the same seeded pools:
  ``horovod_tpu.serving.kv_cache.PagedKVState.gather`` then
  ``flash_decode_attention`` (its Pallas kernel in interpret mode), with
  shuffled page ids in the tables, pad rows (kv_lens 0), lengths of one
  token, of a whole number of pages and of a part page, GQA 4:1 and MHA,
  no window, a window inside one page and one over several pages, fp32
  and bf16.  Tolerances as ``test_torch_flash_attention.py``'s decode
  test: fp32 1e-5, bf16 2e-2 (both sides round the output to bf16 from
  fp32 sums taken in different orders); pad rows exactly zero.
* The CUDA kernel's split plan (``_decode_split_plan`` /
  ``_decode_split_keys``, the rules ``csrc/flash_decode.cu`` applies on
  the card): every visible key, and every live page, falls in exactly
  one split.
* The kernel's split-then-merge, emulated in plain fp32 PyTorch (each
  split's running max, sum and weighted V sum; splits with no key carry
  l = 0; merged in split order), against the unsplit plain version to
  1e-6 for 1, 2, 7 and more splits than pages.

The kernel itself is held against its plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py``.
"""

import itertools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from horovod_tpu.ops import flash_attention as jfa
from horovod_tpu.serving import kv_cache as jkv
from horovod_tpu_torch.ops import flash_attention as tfa


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread is enough, and the suite runs
    several workers side by side on one host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BS, D, LAYERS, LAYER, WIDTH = 8, 16, 2, 1, 8
#: pad row, one token, a whole number of pages, part pages, the bound
KV_LENS = np.array([0, 1, 16, 29, 45, 48], np.int32)


def _pools(seed, h, h_kv, kv_lens=KV_LENS, width=WIDTH, extra=9):
    """Seeded numpy q, pools and block tables whose page ids are a
    shuffle of the pool's blocks (block 0, the trash block, pads the
    tables)."""
    rs = np.random.RandomState(seed)
    need = [-(-int(n) // BS) for n in kv_lens]
    n_blocks = 1 + sum(need) + extra
    k = rs.randn(LAYERS, n_blocks, BS, h_kv, D).astype(np.float32)
    v = rs.randn(LAYERS, n_blocks, BS, h_kv, D).astype(np.float32)
    ids = rs.permutation(np.arange(1, n_blocks))
    tables = np.zeros((len(kv_lens), width), np.int64)
    used = 0
    for i, n in enumerate(need):
        tables[i, :n] = ids[used:used + n]
        used += n
    q = rs.randn(len(kv_lens), 1, h, D).astype(np.float32)
    return q, k, v, tables


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _jax(x, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 3, 19])
@pytest.mark.parametrize("heads", [(8, 2), (4, 4)])
def test_paged_decode_matches_jax_gather_then_decode(heads, window, dtype):
    h, h_kv = heads
    q, k, v, tables = _pools(h * 10 + (window or 0), h, h_kv)
    # the engine's page bound: the live page tier without a window, the
    # whole table with one (the JAX gather ignores the bound then)
    pages = 6 if window is None else None
    js = jkv.PagedKVState(
        k=_jax(k, dtype), v=_jax(v, dtype),
        tables=jnp.asarray(tables.astype(np.int32)),
        lens=jnp.asarray(KV_LENS - 1), mode="decode", gather_pages=pages)
    gk, gv, kv_start = js.gather(LAYER, window=window)
    out_j = jfa.flash_decode_attention(
        _jax(q, dtype), gk, gv, jnp.asarray(KV_LENS), window=window,
        kv_start=kv_start, interpret=True)
    out_t = tfa.flash_decode_paged(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        torch.from_numpy(tables), torch.from_numpy(KV_LENS), layer=LAYER,
        window=window, max_pages=pages)
    assert out_t.dtype == getattr(torch, dtype)
    assert tuple(out_t.shape) == q.shape
    a = out_t.float().numpy()
    b = np.asarray(jnp.asarray(out_j).astype(jnp.float32))
    err = float(np.abs(a - b).max())
    assert err <= TOL[dtype], f"max abs err {err} > {TOL[dtype]}"
    assert bool((out_t[torch.from_numpy(KV_LENS == 0)] == 0).all())


def _visible(kv_len, window, n_cols, bs):
    """The keys the kernel's row attends: ``_tile_mask`` of a causal
    query at ``kv_len - 1`` over the ``n_cols`` pages' keys."""
    k_pos = torch.arange(n_cols * bs)
    mask = tfa._tile_mask(torch.tensor(kv_len - 1), k_pos, True, window,
                          n_cols * bs)
    return k_pos[mask].tolist()


@pytest.mark.parametrize("bs,n_cols,window", [
    (16, 256, None), (16, 256, 256), (8, 6, None), (8, 6, 3), (8, 6, 19),
    (5, 13, 7), (1, 40, None), (16, 4, 100), (3, 11, 1), (1, 9000, None)])
def test_split_plan_covers_every_live_page_once(bs, n_cols, window):
    bound = tfa._decode_page_bound(n_cols, bs, window)
    for blocks in (1, 7, 64, 600):
        nsplit, pps = tfa._decode_split_plan(blocks, bound, bs)
        assert nsplit >= 1 and 1 <= pps <= tfa._MAX_SPLIT_PAGES
        assert nsplit * pps >= bound > (nsplit - 1) * pps
        # no more splits than the SM target or the page cap asks for
        assert nsplit <= max(-(-4 * 132 // blocks),
                             -(-bound // tfa._MAX_SPLIT_PAGES))
        n_keys = n_cols * bs
        for kv_len in sorted(set(range(-2, min(n_keys, 100) + 20))
                             | set(range(100, n_keys + 20, 61))
                             | {n_keys - 1, n_keys, n_keys + 1}):
            keys, pages = [], []
            for s in range(nsplit):
                k0, k1 = tfa._decode_split_keys(s, pps, kv_len, bs, window,
                                                n_cols)
                assert k0 <= k1
                keys += range(k0, k1)
                pages += sorted({k // bs for k in range(k0, k1)})
            assert keys == _visible(kv_len, window, n_cols, bs), (
                blocks, kv_len)
            assert len(pages) == len(set(pages)), (blocks, kv_len, pages)


def _emulate_split_merge(q, k_pool, v_pool, tables, kv_lens, layer, window,
                         max_pages, nsplit, pps):
    """The kernel's arithmetic in plain fp32: each split's (m, l, acc)
    over its own keys read through the table (l = 0 for a split with no
    key), then the merge kernel's combination in split order."""
    b, _, h, d = q.shape
    kp, vp = k_pool[layer].float(), v_pool[layer].float()
    bs, h_kv = kp.shape[1], kp.shape[2]
    n_cols = min(max_pages or tables.shape[1], tables.shape[1])
    qs = q.float() * (1.0 / d ** 0.5)
    out = torch.zeros((b, 1, h, d))
    for i in range(b):
        parts = []
        for s in range(nsplit):
            k0, k1 = tfa._decode_split_keys(s, pps, int(kv_lens[i]), bs,
                                            window, n_cols)
            if k0 == k1:
                parts.append([(tfa._NEG_INF, 0.0, None)] * h)
                continue
            pos = torch.arange(k0, k1)
            page = tables[i, pos // bs]
            keys, vals = kp[page, pos % bs], vp[page, pos % bs]  # (n, Hkv, D)
            per_head = []
            for j in range(h):
                sc = keys[:, j // (h // h_kv)] @ qs[i, 0, j]
                m = sc.max()
                p = torch.exp(sc - m)
                per_head.append((m, p.sum(), p @ vals[:, j // (h // h_kv)]))
            parts.append(per_head)
        for j in range(h):
            live = [pt[j] for pt in parts if pt[j][1] > 0]
            if not live:
                continue
            mx = max(m for m, _, _ in live)
            l = sum(ls * torch.exp(m - mx) for m, ls, _ in live)
            acc = sum(a * torch.exp(m - mx) for m, _, a in live)
            out[i, 0, j] = acc / l
    return out


@pytest.mark.parametrize("nsplit", [1, 2, 7, 40])
@pytest.mark.parametrize("window", [None, 11])
def test_split_then_merge_matches_the_unsplit_plain_version(nsplit, window):
    h, h_kv = 8, 2
    q, k, v, tables = _pools(5 + nsplit, h, h_kv)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    tables, kv_lens = torch.from_numpy(tables), torch.from_numpy(KV_LENS)
    bound = tfa._decode_page_bound(WIDTH, BS, window)
    pps = -(-bound // nsplit)  # 40 splits: past the pages, most are empty
    got = _emulate_split_merge(q, k, v, tables, kv_lens, LAYER, window,
                               None, nsplit, pps)
    want = tfa.flash_decode_paged(q, k, v, tables, kv_lens, layer=LAYER,
                                  window=window)
    err = float((got - want).abs().max())
    assert err <= 1e-6, f"split-then-merge differs by {err}"
    assert bool((got[kv_lens == 0] == 0).all())


def test_paged_decode_equals_the_gathered_decode_of_the_same_pages():
    """The entry on the CPU is the serving gather then the gathered
    decode: bit for bit, windowed and not."""
    q, k, v, tables = _pools(3, 8, 2)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    tables, kv_lens = torch.from_numpy(tables), torch.from_numpy(KV_LENS)
    for window, pages in itertools.product((None, 5), (None, 6)):
        gk, gv, start = tfa.gather_pages(k[LAYER], v[LAYER], tables,
                                         kv_lens - 1, window=window,
                                         max_pages=pages)
        want = tfa.flash_decode_attention(q, gk, gv, kv_lens, window=window,
                                          kv_start=start)
        got = tfa.flash_decode_paged(q, k, v, tables, kv_lens, layer=LAYER,
                                     window=window, max_pages=pages)
        assert torch.equal(got, want)


def test_paged_decode_validates_arguments():
    q, k, v, tables = (torch.from_numpy(x) for x in _pools(0, 4, 2))
    lens = torch.from_numpy(KV_LENS)
    kw = dict(layer=0)
    with pytest.raises(ValueError, match="q_len=1"):
        tfa.flash_decode_paged(q.expand(-1, 2, -1, -1), k, v, tables, lens,
                               **kw)
    with pytest.raises(ValueError, match="5-D"):
        tfa.flash_decode_paged(q, k[0], v[0], tables, lens, **kw)
    with pytest.raises(ValueError, match="layer"):
        tfa.flash_decode_paged(q, k, v, tables, lens, layer=LAYERS)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfa.flash_decode_paged(q[:, :, :3], k, v, tables, lens, **kw)
    with pytest.raises(ValueError, match="tables"):
        tfa.flash_decode_paged(q, k, v, tables[:2], lens, **kw)
    with pytest.raises(ValueError, match="window"):
        tfa.flash_decode_paged(q, k, v, tables, lens, window=0, **kw)
    with pytest.raises(ValueError, match="max_pages"):
        tfa.flash_decode_paged(q, k, v, tables, lens, max_pages=0, **kw)
    # the kernel wrapper refuses CPU tensors (it never falls back)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._decode_paged_cuda(q, k, v, tables, lens.int(), 0, None, None)
