"""Paged KV cache: fixed-size KV blocks in preallocated device pools.

Port of ``horovod_tpu/serving/kv_cache.py`` (vLLM's PagedAttention
scheme): the pools hold ``num_blocks`` blocks of K/V per layer, a
per-sequence *block table* maps logical positions to physical blocks,
and a sequence owns ``ceil(len / block_size)`` blocks at any moment.

* :class:`BlockAllocator` — the host-side refcounted free list with the
  hash-chained prefix cache, unchanged from the JAX package (pure host
  logic; block 0 is the trash block every padded table slot points at).
* :class:`PagedKVState` — one engine step's view of the torch pools,
  block tables and lengths.  Where the JAX state is a functional pytree,
  this one WRITES THE POOLS IN PLACE (``index_put_``): a pool is ~9 GB at
  llama3_8b width, and a copy per step would double it.

The KV snapshot export/import of the JAX allocator (replica migration)
is not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..common.device import resolve_device


def blocks_for(length: int, block_size: int) -> int:
    """Blocks a sequence of ``length`` tokens occupies (ceil division)."""
    return -(-int(length) // int(block_size))


#: Root of every sequence's hash chain (the "parent" of block 0).
PREFIX_HASH_ROOT = 0


def chain_hash(parent_hash: int, tokens: Tuple[int, ...]) -> int:
    """Content hash of one full block chained over its prefix (vLLM's
    prefix-caching scheme).  Process-local; collisions are safe because
    every index hit is confirmed with a full token-id + parent compare."""
    return hash((parent_hash, tokens))


class BlockAllocator:
    """Refcounted allocator over the pool's block ids, with a prefix
    cache (host side).

    Block 0 is never handed out (the trash block).  Allocation is
    all-or-nothing.  A block whose content is registered in the prefix
    index parks on an LRU at refcount 0 — still matchable — and is
    reclaimed (cache entry dropped) only when a fresh allocation drains
    the plain free list; blocks with live references are never evicted.
    """

    def __init__(self, num_blocks: int, block_size: int = 16,
                 prefix_cache: bool = True):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (one is the trash block), got {num_blocks}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.prefix_cache = bool(prefix_cache)
        #: injectable for collision tests (see chain_hash)
        self.hash_fn = chain_hash
        self._ref: List[int] = [0] * self.num_blocks
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        #: cached blocks with refcount 0, oldest first (the evictables)
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        #: chain hash -> block id, for every block with cached content
        self._index: Dict[int, int] = {}
        #: block id -> (chain_hash, parent_hash, token ids)
        self._meta: Dict[int, Tuple[int, int, Tuple[int, ...]]] = {}
        self.peak_occupancy = 0.0

    @property
    def free_blocks(self) -> int:
        """Allocatable blocks: the free list plus the reclaimable LRU."""
        return len(self._free) + len(self._lru)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (pool size minus the trash block)."""
        return self.num_blocks - 1

    @property
    def cached_blocks(self) -> int:
        """Blocks currently holding prefix-cache content."""
        return len(self._index)

    def ref(self, block: int) -> int:
        """Live reference count of ``block`` (0 = free or parked)."""
        return self._ref[block]

    def occupancy(self) -> float:
        """Fraction of allocatable blocks currently owned by sequences."""
        return 1.0 - self.free_blocks / self.capacity

    def _drop_cache_entry(self, b: int) -> None:
        h, _parent, _tokens = self._meta.pop(b)
        if self._index.get(h) == b:
            del self._index[h]

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh block ids at refcount 1, or None if the pool
        can't satisfy all of them.  Drains the free list first, then
        reclaims parked cached blocks in LRU order."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > self.free_blocks:
            return None
        take = min(n, len(self._free))
        taken = list(reversed(self._free[-take:])) if take else []
        del self._free[len(self._free) - take:]
        while len(taken) < n:
            b, _ = self._lru.popitem(last=False)  # oldest cached first
            self._drop_cache_entry(b)
            taken.append(b)
        for b in taken:
            self._ref[b] = 1
        self.peak_occupancy = max(self.peak_occupancy, self.occupancy())
        return taken

    def free(self, blocks: Sequence[int]) -> None:
        """Drop one reference per listed block; at refcount 0 a block
        returns to the free list or, when cached, parks on the LRU."""
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"block id {b} out of range")
            if self._ref[b] <= 0:
                raise ValueError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                if self.prefix_cache and b in self._meta:
                    self._lru[b] = None
                else:
                    if b in self._meta:
                        self._drop_cache_entry(b)
                    self._free.append(b)

    def truncate_tail(self, blocks: List[int], keep_tokens: int
                      ) -> List[int]:
        """Trim a block table to the blocks its first ``keep_tokens``
        tokens occupy, releasing the tail references through
        :meth:`free`.  Returns the surviving prefix (a new list)."""
        keep = blocks_for(keep_tokens, self.block_size) if keep_tokens > 0 \
            else 0
        if keep >= len(blocks):
            return list(blocks)
        self.free(blocks[keep:])
        return list(blocks[:keep])

    # -- the prefix cache ----------------------------------------------------

    def register(self, block: int, parent_hash: int,
                 tokens: Sequence[int]) -> Optional[int]:
        """Publish a FULL, immutable block's content into the prefix
        index; returns its chain hash (None when caching is off).  First
        registration of a hash wins."""
        if not self.prefix_cache:
            return None
        if len(tokens) != self.block_size:
            raise ValueError(
                f"register() takes exactly one full block "
                f"({self.block_size} tokens), got {len(tokens)}")
        if self._ref[block] <= 0 and block not in self._meta:
            raise ValueError(
                f"register of unreferenced block {block} — publish "
                f"full blocks before releasing the sequence")
        toks = tuple(int(t) for t in tokens)
        h = self.hash_fn(parent_hash, toks)
        if h not in self._index:
            self._index[h] = block
            self._meta[block] = (h, parent_hash, toks)
        return h

    def _walk_prefix(self, tokens: Sequence[int],
                     max_blocks: Optional[int]):
        """Yield ``(block, chain_hash)`` per verified cached block of
        ``tokens``' block-aligned prefix, in order."""
        bs = self.block_size
        n_full = len(tokens) // bs
        if max_blocks is not None:
            n_full = min(n_full, max_blocks)
        parent = PREFIX_HASH_ROOT
        for i in range(n_full):
            toks = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            h = self.hash_fn(parent, toks)
            b = self._index.get(h)
            if b is None:
                return
            _h, m_parent, m_tokens = self._meta[b]
            if m_parent != parent or m_tokens != toks:
                return  # hash collision — the full compare rejects it
            yield b, h
            parent = h

    def match_prefix(self, tokens: Sequence[int],
                     max_blocks: Optional[int] = None
                     ) -> Tuple[List[int], List[int]]:
        """Longest cached block-aligned prefix of ``tokens``, taking one
        reference per matched block (un-parking it from the LRU).
        Returns (block ids, chain hashes)."""
        if not self.prefix_cache:
            return [], []
        blocks: List[int] = []
        hashes: List[int] = []
        for b, h in self._walk_prefix(tokens, max_blocks):
            if self._ref[b] == 0:
                self._lru.pop(b, None)
            self._ref[b] += 1
            blocks.append(b)
            hashes.append(h)
        self.peak_occupancy = max(self.peak_occupancy, self.occupancy())
        return blocks, hashes

    def peek_prefix(self, tokens: Sequence[int],
                    max_blocks: Optional[int] = None) -> int:
        """How many leading full blocks of ``tokens`` the index holds,
        without any side effect."""
        if not self.prefix_cache:
            return 0
        return sum(1 for _ in self._walk_prefix(tokens, max_blocks))

    def clear_cache(self) -> None:
        """Drop every prefix-cache entry: parked blocks return to the
        free list; referenced blocks lose their index entries."""
        for b in list(self._lru):
            self._free.append(b)
        self._lru.clear()
        for b in list(self._meta):
            self._drop_cache_entry(b)


@dataclasses.dataclass
class PagedKVState:
    """One engine step's paged-cache state.

    ``k``/``v``: (num_layers, num_blocks, block_size, H_kv, D) pools,
    written IN PLACE by :meth:`write_decode` / :meth:`write_chunk`.
    ``tables``: (B, max_blocks) int64 block tables, rows padded with 0
    (the trash block).  ``lens``: (B,) int32 tokens already written per
    sequence BEFORE this step; pad slots carry 0.  ``mode``: 'decode' |
    'chunk' (the mixed step: row i writes/attends ``chunk_lens[i]`` new
    tokens from its own offset ``lens[i]``).  ``gather_pages`` bounds the
    unwindowed :meth:`gather` copy (the engine's live page tier).
    """

    k: torch.Tensor
    v: torch.Tensor
    tables: torch.Tensor
    lens: torch.Tensor
    mode: str = "decode"
    chunk_lens: Optional[torch.Tensor] = None
    gather_pages: Optional[int] = None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def max_blocks(self) -> int:
        return self.tables.shape[1]

    def write_decode(self, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor) -> None:
        """Scatter one decode token's K/V — (B, 1, H_kv, D) at position
        ``lens`` — into each sequence's tail block (in place)."""
        lens = self.lens.long()
        blk = self.tables.gather(1, (lens // self.block_size)[:, None])[:, 0]
        off = lens % self.block_size
        self.k[layer].index_put_((blk, off), k_new[:, 0])
        self.v[layer].index_put_((blk, off), v_new[:, 0])

    def write_chunk(self, layer: int, k_new: torch.Tensor,
                    v_new: torch.Tensor) -> None:
        """Scatter one mixed-step chunk's K/V — (B, C, H_kv, D), row i's
        tokens at positions ``lens[i] .. lens[i]+chunk_lens[i]-1`` —
        through the block tables (in place).  The table column is
        clamped to ``max_blocks - 1`` and columns beyond a row's
        ``chunk_lens`` go to trash block 0 — the only place duplicate
        indices may land."""
        c = k_new.shape[1]
        rel = torch.arange(c, device=k_new.device)[None]  # (1, C)
        pos = self.lens.long()[:, None] + rel  # (B, C) global positions
        valid = rel < self.chunk_lens.long()[:, None]
        col = torch.clamp(pos // self.block_size, max=self.max_blocks - 1)
        blk = self.tables.gather(1, col)
        blk = torch.where(valid, blk, torch.zeros_like(blk))
        off = pos % self.block_size
        self.k[layer].index_put_((blk, off), k_new)
        self.v[layer].index_put_((blk, off), v_new)

    def gather(self, layer: int, window: Optional[int] = None,
               q_span: int = 1):
        """Gather each sequence's pages contiguous for the kernel:
        returns (k, v, kv_start) with k/v (B, n_blocks*block_size, H_kv,
        D) and kv_start (B,) int32, the global position of each gathered
        row 0.  With ``window`` only the trailing pages that can hold the
        window (widened by ``q_span - 1`` for chunks) are gathered;
        without, ``gather_pages`` bounds the copy."""
        bs = self.block_size
        b = self.tables.shape[0]
        if window is None:
            n = self.gather_pages or self.max_blocks
            tbl = self.tables[:, :n] if n < self.max_blocks else self.tables
            kv_start = torch.zeros((b,), dtype=torch.int32,
                                   device=self.lens.device)
        else:
            n_win = min(self.max_blocks, (window + q_span - 1) // bs + 2)
            first = torch.clamp(
                torch.div(self.lens.long() + 1 - window, bs,
                          rounding_mode="floor"),
                0, self.max_blocks - n_win)
            idx = first[:, None] + torch.arange(n_win, device=first.device)
            tbl = self.tables.gather(1, idx)
            kv_start = (first * bs).to(torch.int32)
        n = tbl.shape[1]
        h_kv, d = self.k.shape[3], self.k.shape[4]
        gk = self.k[layer][tbl].reshape(b, n * bs, h_kv, d)
        gv = self.v[layer][tbl].reshape(b, n * bs, h_kv, d)
        return gk, gv, kv_start


def make_pools(num_layers: int, num_blocks: int, block_size: int,
               num_kv_heads: int, head_dim: int, dtype,
               device=None) -> tuple:
    """Zeroed (k, v) pools: (L, N, block_size, H_kv, D) each, on
    ``device`` (default: the first CUDA card; raises without one)."""
    device = resolve_device(device)
    shape = (num_layers, num_blocks, block_size, num_kv_heads, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def pool_bytes(num_layers: int, num_blocks: int, block_size: int,
               num_kv_heads: int, head_dim: int, dtype) -> int:
    """Bytes of one K+V pool pair."""
    per = num_layers * num_blocks * block_size * num_kv_heads * head_dim
    return 2 * per * torch.empty((), dtype=dtype).element_size()


def modeled_decode_read_bytes(context_len: int, *, block_size: int,
                              num_heads: int, num_kv_heads: int,
                              head_dim: int, num_layers: int,
                              window: Optional[int] = None,
                              dtype_bytes: int = 2,
                              max_seq_len: Optional[int] = None,
                              gather_pages: Optional[int] = None) -> dict:
    """Modeled K/V bytes ONE sequence's decode step reads, paged vs the
    dense full-context baseline (pure block arithmetic, as in the JAX
    package): ``paged_bytes`` — the owned pages holding live positions,
    once per KV head (what the kernel reads); ``gathered_bytes`` — what
    :meth:`PagedKVState.gather` copies first; ``full_bytes`` — a
    contiguous ``max_seq_len`` MHA buffer."""
    max_pages = blocks_for(max_seq_len or context_len, block_size)
    span = context_len if window is None else min(context_len, window + 1)
    pages = blocks_for(span, block_size) + (
        0 if window is None else 1)  # alignment slack page
    pages = min(pages, max_pages)
    if window is not None:
        gathered = min(max_pages, window // block_size + 2)
    elif gather_pages is not None:
        gathered = min(max_pages, max(gather_pages, pages))
    else:
        gathered = max_pages
    per_kv_page = 2 * block_size * num_kv_heads * head_dim
    full = max_seq_len if max_seq_len is not None else context_len
    per_layer_full = 2 * full * num_heads * head_dim
    return {
        "paged_bytes": num_layers * pages * per_kv_page * dtype_bytes,
        "gathered_bytes": num_layers * gathered * per_kv_page * dtype_bytes,
        "full_bytes": num_layers * per_layer_full * dtype_bytes,
        "pages_read": pages,
        "pages_gathered": gathered,
    }
