"""Iteration-level (continuous-batching) request scheduler.

Port of ``horovod_tpu/serving/scheduler.py`` (Orca, OSDI '22): the batch
is re-decided every step — finished sequences leave at once, waiting
requests join as soon as a slot and KV blocks are free.  The decisions
are the JAX package's, unchanged:

* **prefix cache on admit** — the longest cached block-aligned prefix of
  each context maps into the new sequence's table with refcount bumps,
  capped one block short of the context (the prefill step must compute
  at least one token, and the partial last block stays private);
* **admission gates** — the uncached prompt tokens of one admission
  batch are capped by ``token_budget``, the batch by the largest decode
  tier, and allocation must leave ``watermark`` free blocks;
* **LIFO recompute eviction** — when a growing sequence needs a block
  and the pool is dry, the most recently admitted sequence is preempted
  and re-queued with the tokens it already generated.

Everything here is host bookkeeping over the
:class:`~horovod_tpu_torch.serving.kv_cache.BlockAllocator`; the device
work happens in :mod:`.engine`.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional

import numpy as np

from .. import trace
from ..metrics import instruments as _instr
from .kv_cache import PREFIX_HASH_ROOT, BlockAllocator, blocks_for


@dataclasses.dataclass
class Request:
    """One generation request as submitted by the client."""

    id: int
    prompt: np.ndarray  # int32 token ids, 1-D
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival: float = 0.0
    #: latency budget in seconds from ``arrival`` (None/0 = none)
    deadline_s: Optional[float] = None
    #: propagated trace context, carried on every span of the request
    trace_id: Optional[str] = None


@dataclasses.dataclass
class Sequence:
    """A request's live serving state.  ``context`` is what the next
    prefill must write: the prompt plus, after an eviction, the tokens
    already generated."""

    req: Request
    context: np.ndarray
    generated: List[int] = dataclasses.field(default_factory=list)
    blocks: List[int] = dataclasses.field(default_factory=list)
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    #: context tokens whose K/V are in the cache (prefix hits at admit
    #: plus chunks computed since)
    prefilled: int = 0
    #: of ``prefilled``, how many came from prefix-cache hits at admit
    cached_len: int = 0
    #: chain hashes of this stream's full blocks
    block_hashes: List[int] = dataclasses.field(default_factory=list)
    #: how many of ``blocks`` are published in the prefix index
    published: int = 0

    @property
    def length(self) -> int:
        """Tokens currently in the KV cache once prefill has run."""
        return len(self.context) + len(self.generated)

    @property
    def in_decode(self) -> bool:
        """Prefill complete — the sequence decodes one token per step."""
        return self.prefilled >= len(self.context)

    @property
    def tokens_in_cache(self) -> int:
        """Tokens whose K/V are physically written: ``prefilled`` during
        prefill, ``length - 1`` during decode (the newest token's K/V
        lands on the next step)."""
        if not self.in_decode:
            return self.prefilled
        return len(self.context) + max(len(self.generated) - 1, 0)

    @property
    def done(self) -> bool:
        n = len(self.generated) + (len(self.context) - len(self.req.prompt))
        if n >= self.req.max_new_tokens:
            return True
        eos = self.req.eos_id
        return eos is not None and len(self.generated) > 0 \
            and self.generated[-1] == eos

    def expired(self, now: float) -> bool:
        """Deadline budget spent (measured from ``arrival``)."""
        d = self.req.deadline_s
        return bool(d) and d > 0 and (now - self.req.arrival) > d


class ContinuousBatchingScheduler:
    """Admit/evict sequences against a token budget and a block pool."""

    def __init__(self, allocator: BlockAllocator, *, token_budget: int,
                 watermark: int, max_decode_batch: int,
                 max_seq_len: int):
        if token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        if watermark < 0:
            raise ValueError(f"watermark must be >= 0, got {watermark}")
        need_one = blocks_for(max_seq_len, allocator.block_size)
        if need_one > allocator.capacity:
            raise ValueError(
                f"pool of {allocator.capacity} blocks cannot hold one "
                f"max_seq_len={max_seq_len} sequence ({need_one} blocks) — "
                f"a lone sequence could deadlock growth")
        self.allocator = allocator
        self.token_budget = int(token_budget)
        self.watermark = int(watermark)
        self.max_decode_batch = int(max_decode_batch)
        self.max_seq_len = int(max_seq_len)
        self.pending: Deque[Sequence] = collections.deque()
        self.running: List[Sequence] = []
        #: deadline-shed/cancelled sequences awaiting finalization
        self.shed: List[Sequence] = []
        self.evictions = 0
        self.prefix_hit_blocks = 0
        self.prefix_lookup_blocks = 0

    def queue_depth(self) -> int:
        """Requests waiting for admission."""
        return len(self.pending)

    def submit(self, seq: Sequence) -> None:
        self.pending.append(seq)
        self._book()

    def _book(self) -> None:
        _instr.SERVE_QUEUE_DEPTH.set(self.queue_depth())
        _instr.SERVE_KV_OCCUPANCY.set(self.allocator.occupancy())
        _instr.SERVE_KV_CACHED.set(
            self.allocator.cached_blocks / self.allocator.capacity)

    def finish(self, seq: Sequence) -> None:
        """Release a completed sequence's blocks and batch slot."""
        self.running.remove(seq)
        self.allocator.free(seq.blocks)
        seq.blocks = []
        self._book()

    def _evict_one(self) -> bool:
        """Preempt the most recently admitted sequence (LIFO recompute):
        it re-queues at the front with prompt + generated as its context,
        and re-admission prefix-matches whatever of its blocks survived."""
        if len(self.running) <= 1:
            return False
        victim = self.running.pop()
        self.allocator.free(victim.blocks)
        victim.blocks = []
        victim.context = np.concatenate([
            victim.context, np.asarray(victim.generated, np.int32)])
        victim.generated = []
        victim.prefilled = 0
        victim.cached_len = 0
        victim.published = 0
        self.pending.appendleft(victim)
        self.evictions += 1
        _instr.SERVE_EVICTIONS.inc()
        self._book()
        return True

    def publish_full_blocks(self, seq: Sequence) -> None:
        """Register ``seq``'s newly-full blocks in the prefix index (the
        engine calls this after every step, before emission)."""
        if not self.allocator.prefix_cache:
            return
        bs = self.allocator.block_size
        n_full = min(seq.tokens_in_cache // bs, len(seq.blocks))
        if seq.published >= n_full:
            return
        stream = seq.context if not seq.generated else np.concatenate(
            [seq.context, np.asarray(seq.generated, np.int32)])
        while seq.published < n_full:
            i = seq.published
            parent = seq.block_hashes[i - 1] if i else PREFIX_HASH_ROOT
            h = self.allocator.register(
                seq.blocks[i], parent, stream[i * bs:(i + 1) * bs])
            if len(seq.block_hashes) > i:
                seq.block_hashes[i] = h
            else:
                seq.block_hashes.append(h)
            seq.published += 1

    def _shed(self, seq: Sequence) -> None:
        self.shed.append(seq)
        _instr.SERVE_DEADLINE_EXCEEDED.inc()

    def cancel_expired(self, now: float) -> List[Sequence]:
        """Shed pending requests past their deadline and cancel expired
        in-flight sequences; returns the newly shed sequences."""
        out: List[Sequence] = []
        for seq in [s for s in self.pending if s.expired(now)]:
            self.pending.remove(seq)
            self._shed(seq)
            out.append(seq)
        for seq in [s for s in self.running if s.expired(now)]:
            self.finish(seq)
            self._shed(seq)
            out.append(seq)
        if out:
            self._book()
        return out

    def grow_running(self) -> None:
        """Before a step: every running sequence is about to gain a
        token — allocate tail blocks, evicting LIFO when the pool is dry."""
        for seq in list(self.running):
            if seq not in self.running:
                continue  # evicted by an earlier iteration
            while True:
                need = blocks_for(seq.length + 1, self.allocator.block_size)
                if need <= len(seq.blocks):
                    break
                got = self.allocator.alloc(need - len(seq.blocks))
                if got is not None:
                    seq.blocks.extend(got)
                    break
                if not self._evict_one() or seq not in self.running:
                    break
        self._book()

    def admit(self, now: Optional[float] = None) -> List[Sequence]:
        """Admit pending sequences while the token budget, the decode
        slots and the block watermark permit; each first prefix-matches
        its context and allocates only the uncached tail.  With ``now``,
        requests already past their deadline are shed instead.  Returns
        the admitted batch."""
        batch: List[Sequence] = []
        tokens = 0
        bs = self.allocator.block_size
        while self.pending:
            seq = self.pending[0]
            if now is not None and seq.expired(now):
                self.pending.popleft()
                self._shed(seq)
                continue
            ctx = len(seq.context)
            if len(self.running) + len(batch) + 1 > self.max_decode_batch:
                break
            matched, hashes = self.allocator.match_prefix(
                seq.context, max_blocks=(ctx - 1) // bs)
            cached = len(matched) * bs
            tail = ctx - cached
            if batch and tokens + tail > self.token_budget:
                self.allocator.free(matched)  # undo the match's refs
                break
            need = blocks_for(ctx + 1, bs) - len(matched)
            # the watermark bypass exists only for the progress guarantee
            # (an idle engine must admit something)
            if self.allocator.free_blocks - need < self.watermark and (
                    batch or self.running):
                self.allocator.free(matched)
                break
            got = self.allocator.alloc(need)
            if got is None:
                self.allocator.free(matched)
                break
            # CoW invariant: every position the prefill writes lands in a
            # freshly allocated private block
            assert all(self.allocator.ref(b) == 1 for b in got)
            if self.allocator.prefix_cache:
                lookup = (ctx - 1) // bs
                self.prefix_lookup_blocks += lookup
                self.prefix_hit_blocks += len(matched)
                _instr.SERVE_PREFIX_HITS.inc(len(matched))
                _instr.SERVE_PREFIX_MISSES.inc(lookup - len(matched))
            seq.blocks = matched + got
            seq.cached_len = cached
            seq.prefilled = cached
            seq.published = len(matched)
            seq.block_hashes[:len(hashes)] = hashes
            if seq.req.arrival > 0 and trace.enabled():
                t1 = trace.now()
                waited = max(0.0, (now if now is not None else t1)
                             - seq.req.arrival)
                trace.add_span("serve.queued", t1 - waited, t1,
                               rid=seq.req.id, cached_blocks=len(matched),
                               trace=seq.req.trace_id)
            batch.append(self.pending.popleft())
            tokens += tail
        self.running.extend(batch)
        self._book()
        return batch
