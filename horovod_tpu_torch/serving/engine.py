"""The serving engine: continuous batching over the paged KV cache.

Port of ``horovod_tpu/serving/engine.py`` (single device): the
scheduler re-decides the batch every step, and each step runs ONE of two
program families over *padding tiers* —

* a MIXED step packs the running decode batch plus prefill chunks
  (Sarathi-style chunked prefill: a chunk at offset k is just another
  batch row of the per-row-offset attention kernel), keyed by (batch
  tier, chunk tier);
* a DECODE step, keyed by (batch tier, page tier): the decode kernel
  reads the pools in place through the block tables, no further than the
  batch's live max-context page tier.

Every attention call of either family runs the hand-written kernel of
``ops/flash_attention.py`` once per layer.  PyTorch runs eagerly, so the
tiers bound the set of step shapes rather than a set of compiled
programs (and nothing is booked into the executable-cache counters);
capturing the tier menu as CUDA graphs is later work.

Decoding is greedy (argmax of fp32 logits): batched decode over the
paged cache emits token for token what one-at-a-time full-context
decode emits, across admit/evict boundaries.

Not ported yet (``ServeConfig`` fields that select them raise
``NotImplementedError``): speculative decoding, tensor sharding; also
the staged intake (``attach_source``), KV snapshot export/import, the
prefill role, ``run_static`` and the lowered-program views.
"""

from __future__ import annotations

import bisect
import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..common.device import resolve_device
from ..common.retry import env_float, env_int
from ..metrics import instruments as _instr
from ..models.transformer import Transformer, TransformerConfig
from ..utils.logging import get_logger
from .kv_cache import (
    BlockAllocator, PagedKVState, blocks_for, make_pools, pool_bytes,
)
from .scheduler import ContinuousBatchingScheduler, Request, Sequence

_LAT_FIRST = _instr.SERVE_TOKEN_LATENCY.labels("first")
_LAT_INTER = _instr.SERVE_TOKEN_LATENCY.labels("inter")
_STEP_MIXED = _instr.SERVE_STEPS.labels("mixed")
_STEP_DECODE = _instr.SERVE_STEPS.labels("decode")
_REQ_SUBMITTED = _instr.SERVE_REQUESTS.labels("submitted")
_REQ_COMPLETED = _instr.SERVE_REQUESTS.labels("completed")

_PREFILL_TIERS_ENV = "HVD_TPU_SERVE_PREFILL_TIERS"
_DECODE_TIERS_ENV = "HVD_TPU_SERVE_DECODE_TIERS"


def _env_tiers(name: str, default: Tuple[int, ...]) -> Tuple[int, ...]:
    """Comma-separated tier menu from the environment: positive powers
    of two in strictly ascending order, or ``ValueError``."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        tiers = tuple(int(x) for x in raw.split(",") if x.strip())
        if not tiers:
            raise ValueError("empty")
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not a comma-separated int list") from None
    bad = [t for t in tiers if t < 1 or t & (t - 1)]
    if bad:
        raise ValueError(
            f"{name}={raw!r}: tiers must be powers of two >= 1 "
            f"(got {bad}) — tiers key the step shapes and the menus "
            f"assume power-of-two growth.  (A non-power-of-two "
            f"max_seq_len needs no entry: the engine appends it to the "
            f"prefill menu itself for post-evict re-prefills.)")
    if any(b <= a for a, b in zip(tiers, tiers[1:])):
        raise ValueError(
            f"{name}={raw!r}: tiers must be strictly ascending "
            f"(_tier_for bisects the menu)")
    return tiers


def _pow2_tiers(lo: int, hi: int) -> Tuple[int, ...]:
    tiers = []
    t = lo
    while t < hi:
        tiers.append(t)
        t *= 2
    tiers.append(hi)
    return tuple(tiers)


def _tier_for(tiers: Tuple[int, ...], n: int) -> int:
    """Smallest tier >= n (tiers ascending)."""
    i = bisect.bisect_left(tiers, n)
    if i == len(tiers):
        raise ValueError(f"{n} exceeds the largest tier {tiers[-1]}")
    return tiers[i]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving knobs (every field has an ``HVD_TPU_SERVE_*`` env
    spelling resolved by :meth:`from_env`).

    ``prefill_tiers`` / ``decode_tiers`` are the padding menus;
    ``prefill_chunk`` > 0 streams prompt tails in chunks of at most this
    many tokens, each packed into a mixed step beside the decode batch
    (0 = a tail prefills in one chunk); ``prefix_cache`` toggles prompt
    prefix caching (greedy outputs are bit-identical either way)."""

    block_size: int = 16
    num_blocks: int = 0  # 0 = auto: full residency for the largest batch
    token_budget: int = 2048
    watermark: int = 4
    prefill_tiers: Tuple[int, ...] = ()
    decode_tiers: Tuple[int, ...] = (1, 2, 4, 8)
    prefill_chunk: int = 0
    prefix_cache: bool = True
    #: default per-request latency budget in seconds (0 = none)
    deadline_s: float = 0.0
    #: tensor sharding over several cards — not ported yet (> 1 raises)
    shards: int = 1
    #: speculative decoding — not ported yet (True raises)
    spec: bool = False

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        base = cls(**overrides)
        fields = dataclasses.asdict(base)
        ints = {"block_size": "BLOCK_SIZE", "num_blocks": "NUM_BLOCKS",
                "token_budget": "TOKEN_BUDGET", "watermark": "WATERMARK",
                "prefill_chunk": "PREFILL_CHUNK", "shards": "SHARDS"}
        for field, env in ints.items():
            if field not in overrides:
                fields[field] = env_int(f"HVD_TPU_SERVE_{env}",
                                        getattr(base, field))
        if "prefill_tiers" not in overrides:
            fields["prefill_tiers"] = _env_tiers(
                _PREFILL_TIERS_ENV, base.prefill_tiers)
        if "decode_tiers" not in overrides:
            fields["decode_tiers"] = _env_tiers(
                _DECODE_TIERS_ENV, base.decode_tiers)
        if "prefix_cache" not in overrides:
            fields["prefix_cache"] = bool(env_int(
                "HVD_TPU_SERVE_PREFIX_CACHE", int(base.prefix_cache)))
        if "deadline_s" not in overrides:
            fields["deadline_s"] = env_float("HVD_TPU_SERVE_DEADLINE",
                                             base.deadline_s)
        if "spec" not in overrides:
            fields["spec"] = bool(env_int("HVD_TPU_SERVE_SPEC",
                                          int(base.spec)))
        return cls(**fields)


class ServingEngine:
    """Continuous-batching inference over one :class:`Transformer`.

    ``params`` is the model's state dict (``init_params`` /
    ``params_from_flax``), adopted without a copy when it already lies on
    ``device``.  The config must be causal with attention_impl 'dot' or
    'flash'; GQA and sliding windows shrink the cache and the decode
    reads natively.  ``device`` defaults to the first CUDA card and
    raises without one; ``device="cpu"`` runs the kernels' plain
    versions (the tests).  The KV pools are updated in place."""

    def __init__(self, cfg: TransformerConfig, params, *,
                 serve: Optional[ServeConfig] = None, device=None,
                 clock=time.perf_counter):
        if cfg.attention_impl not in ("dot", "flash") or not cfg.causal:
            raise ValueError(
                "serving requires a causal 'dot' or 'flash' config, got "
                f"attention_impl={cfg.attention_impl!r} causal={cfg.causal}")
        self.serve_cfg = serve = serve or ServeConfig.from_env()
        if serve.shards > 1:
            raise NotImplementedError(
                f"tensor-sharded serving (shards={serve.shards}) is not "
                f"ported yet; use shards=1")
        if serve.spec:
            raise NotImplementedError(
                "speculative decoding is not ported yet; use spec=False")
        self.device = resolve_device(device)
        self.cfg = cfg
        self._clock = clock
        self.model = Transformer(cfg, params={
            k: v.to(self.device) for k, v in params.items()})
        bs = serve.block_size
        self.max_blocks_per_seq = blocks_for(cfg.max_seq_len, bs)
        max_batch = max(serve.decode_tiers)
        num_blocks = serve.num_blocks
        if num_blocks <= 0:
            num_blocks = 1 + self.max_blocks_per_seq * max_batch
        prefill_tiers = serve.prefill_tiers or _pow2_tiers(
            min(32, cfg.max_seq_len), cfg.max_seq_len)
        over = [t for t in prefill_tiers if t > cfg.max_seq_len]
        if over:
            # pad positions past max_seq_len would index table columns
            # past max_blocks (the clamped write would alias a real block)
            get_logger().warning(
                "dropping prefill tiers %s > max_seq_len %d", over,
                cfg.max_seq_len)
            prefill_tiers = tuple(
                t for t in prefill_tiers if t <= cfg.max_seq_len)
        if not prefill_tiers or prefill_tiers[-1] < cfg.max_seq_len:
            prefill_tiers = prefill_tiers + (cfg.max_seq_len,)
        self.prefill_tiers = prefill_tiers
        self.decode_tiers = serve.decode_tiers
        if serve.prefill_chunk > 0:
            cap = min(serve.prefill_chunk, cfg.max_seq_len)
            self.chunk_tiers = tuple(
                t for t in prefill_tiers if t < cap) + (cap,)
        else:
            self.chunk_tiers = prefill_tiers
        if cfg.window is None:
            self.page_tiers = _pow2_tiers(1, self.max_blocks_per_seq)
        else:
            self.page_tiers = (self.max_blocks_per_seq,)
        self.num_blocks = num_blocks
        self.k_pool, self.v_pool = make_pools(
            cfg.num_layers, num_blocks, bs, cfg.kv_heads, cfg.head_dim,
            cfg.dtype, device=self.device)
        self.pool_bytes = pool_bytes(
            cfg.num_layers, num_blocks, bs, cfg.kv_heads, cfg.head_dim,
            cfg.dtype)
        _instr.SERVE_KV_BLOCKS_PER_SHARD.set(num_blocks)
        self.allocator = BlockAllocator(
            num_blocks, bs, prefix_cache=serve.prefix_cache)
        self.scheduler = ContinuousBatchingScheduler(
            self.allocator, token_budget=serve.token_budget,
            watermark=serve.watermark, max_decode_batch=max_batch,
            max_seq_len=cfg.max_seq_len)
        self.results: Dict[int, np.ndarray] = {}
        self._any_deadline = serve.deadline_s > 0
        #: set to a list to record (request_id, emit_time, arrival) per
        #: token
        self.token_log: Optional[list] = None
        #: set to a dict to keep, per request id, the fp32 logits row
        #: (host tensor) its first token was taken from
        self.first_logits: Optional[dict] = None
        self._last_logits: Optional[torch.Tensor] = None
        self._next_id = 0
        self._last_step: Optional[tuple] = None
        #: chunk tokens actually computed by prefill (prefix-cache hits
        #: and pad columns excluded)
        self.prefill_tokens_computed = 0
        #: steps run (mixed + decode); each runs the attention kernel
        #: once per layer
        self.steps = 0

    # -- the two tiered program families ------------------------------------

    def _mixed_step(self, tables, lens, chunk_lens, tokens, pages=None):
        """One mixed chunked-prefill + decode step: row i writes and
        attends ``chunk_lens[i]`` new tokens at global offset ``lens[i]``.
        Returns the greedy token at EVERY position, (B, C) on device."""
        state = PagedKVState(k=self.k_pool, v=self.v_pool, tables=tables,
                             lens=lens, mode="chunk", chunk_lens=chunk_lens,
                             gather_pages=pages)
        c = tokens.shape[1]
        positions = lens.long()[:, None] + torch.arange(
            c, device=tokens.device)[None]
        logits = self.model(tokens, positions=positions, paged=state)
        if self.first_logits is not None:
            self._last_logits = logits
        return torch.argmax(logits.float(), dim=-1)

    def _decode_step(self, tables, lens, last_tok, pages):
        state = PagedKVState(k=self.k_pool, v=self.v_pool, tables=tables,
                             lens=lens, mode="decode", gather_pages=pages)
        logits = self.model(last_tok[:, None], positions=lens.long()[:, None],
                            paged=state)
        return torch.argmax(logits[:, 0].float(), dim=-1)

    def warmup(self) -> int:
        """Build the kernel library (on a card) and run one step of each
        program family at its smallest tiers, with all-zero block tables
        so every write lands in the trash block.  Returns the number of
        warm-up steps run (one per family)."""
        if self.device.type == "cuda":
            from ..ops import _build

            _build.build_all()
        bt, c, pt = (self.decode_tiers[0], self.chunk_tiers[0],
                     self.page_tiers[0])
        dev = self.device
        tables = torch.zeros((bt, self.max_blocks_per_seq), dtype=torch.long,
                             device=dev)
        zeros = torch.zeros((bt,), dtype=torch.int32, device=dev)
        ones = torch.ones((bt,), dtype=torch.int32, device=dev)
        with torch.inference_mode():
            self._mixed_step(tables, zeros, ones,
                             torch.zeros((bt, c), dtype=torch.long,
                                         device=dev))
            self._decode_step(tables, ones, torch.zeros(
                (bt,), dtype=torch.long, device=dev), pt)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return 2

    # -- request intake ------------------------------------------------------

    def _validate_request(self, prompt_len: int, max_new_tokens: int) -> None:
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1 (the prefill step always "
                f"emits one token), got {max_new_tokens}")
        if prompt_len + max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_seq_len {self.cfg.max_seq_len}")

    def submit(self, prompt, max_new_tokens: int, *, eos_id=None,
               arrival: Optional[float] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None) -> int:
        """Enqueue one request; returns its id (key into ``results``)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self._validate_request(len(prompt), max_new_tokens)
        if deadline_s is None:
            deadline_s = self.serve_cfg.deadline_s
        req = Request(
            id=self._next_id, prompt=prompt,
            max_new_tokens=int(max_new_tokens), eos_id=eos_id,
            arrival=self._clock() if arrival is None else arrival,
            deadline_s=deadline_s if deadline_s and deadline_s > 0
            else None, trace_id=trace_id)
        self._next_id += 1
        if req.deadline_s:
            self._any_deadline = True
        self.scheduler.submit(Sequence(req=req, context=prompt))
        _REQ_SUBMITTED.inc()
        return req.id

    # -- batch assembly ------------------------------------------------------

    def _batch_tier(self, n: int) -> int:
        return _tier_for(self.decode_tiers, n)

    def _tables_lens(self, seqs: List[Sequence], bt: int, lens: List[int]):
        tables = np.zeros((bt, self.max_blocks_per_seq), np.int64)
        for i, s in enumerate(seqs):
            tables[i, :len(s.blocks)] = s.blocks
        lens_arr = np.zeros((bt,), np.int32)
        lens_arr[:len(seqs)] = lens
        return (torch.from_numpy(tables).to(self.device),
                torch.from_numpy(lens_arr).to(self.device))

    def _chunk_row(self, s: Sequence, c: int, width: int) -> np.ndarray:
        """One prefill chunk's tokens — ``context[prefilled:prefilled+c]``
        — padded to the chunk tier ``width`` (host-assembled)."""
        host = np.zeros((width,), np.int64)
        host[:c] = s.context[s.prefilled:s.prefilled + c]
        return host

    def _select_chunks(self, prefill_rows: List[Sequence], slots: int):
        """Chunk work for one mixed step: FIFO over sequences still
        prefilling, each chunk capped by ``prefill_chunk``; the token
        budget caps how many chunks pack into one step (first chunk
        always admitted).  Returns [(seq, chunk_len)]."""
        cap = self.serve_cfg.prefill_chunk or max(self.chunk_tiers)
        left = self.scheduler.token_budget
        sel: List[Tuple[Sequence, int]] = []
        for s in prefill_rows:
            if len(sel) >= slots:
                break
            rem = len(s.context) - s.prefilled
            c = min(rem, cap)
            if sel and c > left:
                break
            sel.append((s, c))
            left -= c
        return sel

    def _run_mixed(self, decode_rows: List[Sequence], chunk_sel):
        """Execute ONE mixed step over ``decode_rows`` (one token each)
        plus ``chunk_sel``; row order: decode rows first, chunk rows
        after.  Returns the (batch tier, width) per-position argmax grid
        (host) and the emission time."""
        n = len(decode_rows) + len(chunk_sel)
        bt = self._batch_tier(n)
        width = _tier_for(
            self.chunk_tiers, max([c for _, c in chunk_sel], default=1))
        tokens = np.zeros((bt, width), np.int64)
        lens_list = []
        chunk_lens = np.zeros((bt,), np.int32)
        for i, s in enumerate(decode_rows):
            tokens[i, 0] = s.generated[-1]
            lens_list.append(s.length - 1)
            chunk_lens[i] = 1
        for j, (s, c) in enumerate(chunk_sel):
            tokens[len(decode_rows) + j] = self._chunk_row(s, c, width)
            lens_list.append(s.prefilled)
            chunk_lens[len(decode_rows) + j] = c
        tables, lens = self._tables_lens(
            decode_rows + [s for s, _ in chunk_sel], bt, lens_list)
        tracing = trace.enabled()
        t0 = trace.now() if tracing else 0.0
        with torch.inference_mode():
            next_tok = self._mixed_step(
                tables, lens, torch.from_numpy(chunk_lens).to(self.device),
                torch.from_numpy(tokens).to(self.device))
        out = next_tok.cpu().numpy()  # device sync: the step's true extent
        if tracing:
            t1 = trace.now()
            self._last_step = ("mixed", t0, t1)
            trace.add_span("serve.step", t0, t1, kind="mixed", batch=n,
                           chunks=len(chunk_sel),
                           rids=[s.req.id for s in decode_rows])
            for s, c in chunk_sel:
                trace.add_span("serve.prefill_chunk", t0, t1,
                               rid=s.req.id, chunk=int(c),
                               offset=int(s.prefilled),
                               trace=s.req.trace_id)
        _STEP_MIXED.inc()
        _instr.SERVE_PREFILL_CHUNKS.inc(len(chunk_sel))
        self.prefill_tokens_computed += sum(c for _, c in chunk_sel)
        self.steps += 1
        return out, self._clock()

    def _decode_once(self, seqs: List[Sequence]):
        """One decode step over ``seqs`` (the newest token's K/V is
        written by THIS step, at position length - 1); the unwindowed
        decode reads no further than the batch's live page tier."""
        bt = self._batch_tier(len(seqs))
        cache_lens = [s.length - 1 for s in seqs]
        pages = self.max_blocks_per_seq
        if self.cfg.window is None:
            need = max(blocks_for(s.length, self.serve_cfg.block_size)
                       for s in seqs)
            pages = _tier_for(self.page_tiers, need)
        tables, lens = self._tables_lens(seqs, bt, cache_lens)
        last = np.zeros((bt,), np.int64)
        last[:len(seqs)] = [s.generated[-1] for s in seqs]
        tracing = trace.enabled()
        t0 = trace.now() if tracing else 0.0
        with torch.inference_mode():
            next_tok = self._decode_step(
                tables, lens, torch.from_numpy(last).to(self.device), pages)
        out = next_tok.cpu().numpy()  # device sync: the step's true extent
        if tracing:
            t1 = trace.now()
            self._last_step = ("decode", t0, t1)
            trace.add_span("serve.step", t0, t1, kind="decode",
                           batch=len(seqs), rids=[s.req.id for s in seqs])
        _STEP_DECODE.inc()
        self.steps += 1
        return out, self._clock()

    # -- token emission ------------------------------------------------------

    def _observe_token(self, seq: Sequence, token: int, now: float) -> None:
        seq.generated.append(int(token))
        if self.token_log is not None:
            self.token_log.append((seq.req.id, now, seq.req.arrival))
        if seq.first_token_at is None:
            seq.first_token_at = now
            _LAT_FIRST.observe(now - seq.req.arrival)
            trace.event("serve.first_token", rid=seq.req.id,
                        ttft=now - seq.req.arrival, trace=seq.req.trace_id)
            if self._last_step is not None and \
                    self._last_step[0] == "decode":
                trace.add_span("serve.first_decode", self._last_step[1],
                               self._last_step[2], rid=seq.req.id,
                               trace=seq.req.trace_id)
        elif seq.last_token_at is not None:
            # after an eviction the gap includes the requeue wait and
            # the re-prefill — the stall the user sees
            _LAT_INTER.observe(now - seq.last_token_at)
        seq.last_token_at = now

    def _emit(self, seq: Sequence, token: int, now: float) -> None:
        self._observe_token(seq, token, now)
        if seq.done:
            trace.event("serve.finish", rid=seq.req.id,
                        tokens=len(seq.generated), trace=seq.req.trace_id)
            self.scheduler.finish(seq)
            self.results[seq.req.id] = self._partial_result(seq)
            _REQ_COMPLETED.inc()

    def _partial_result(self, seq: Sequence) -> np.ndarray:
        """Tokens folded into the context by evictions plus those
        generated since."""
        return np.concatenate([
            seq.context[len(seq.req.prompt):].astype(np.int32),
            np.asarray(seq.generated, np.int32)])

    def _finalize_shed(self) -> None:
        for seq in self.scheduler.shed:
            self.results[seq.req.id] = self._partial_result(seq)
            _instr.SERVE_REQUESTS.labels("expired").inc()
        self.scheduler.shed.clear()

    # -- the scheduler loop --------------------------------------------------

    def step(self) -> bool:
        """One iteration: admit (prefix-matching), grow, then run ONE
        step — a MIXED step whenever prefill work is pending, a decode
        step otherwise.  Returns False when there is nothing left."""
        if self._any_deadline:
            now = self._clock()
            self.scheduler.cancel_expired(now)
            self.scheduler.admit(now)
            self._finalize_shed()
        else:
            self.scheduler.admit()
        self.scheduler.grow_running()
        running = list(self.scheduler.running)
        decode_rows = [s for s in running if s.in_decode]
        prefill_rows = [s for s in running if not s.in_decode]
        if prefill_rows:
            # decode rows ride the mixed step ONLY under chunked prefill;
            # unchunked, the chunk width is the whole prompt tier and the
            # prefill-only step is kept verbatim
            if self.serve_cfg.prefill_chunk <= 0:
                decode_rows = []
            bt_max = max(self.decode_tiers)
            sel = self._select_chunks(
                prefill_rows, bt_max - len(decode_rows))
            toks, now = self._run_mixed(decode_rows, sel)
            for s, c in sel:
                s.prefilled += c
            # publish BEFORE emission: _emit may release a sequence's
            # blocks, and a block must never be registered after release
            for s in running:
                if s.blocks:
                    self.scheduler.publish_full_blocks(s)
            for i, s in enumerate(decode_rows):
                self._emit(s, toks[i, 0], now)
            base = len(decode_rows)
            for j, (s, c) in enumerate(sel):
                if s.in_decode:  # prompt complete -> its first token
                    if self.first_logits is not None and not s.generated:
                        self.first_logits.setdefault(
                            s.req.id,
                            self._last_logits[base + j, c - 1].float().cpu())
                    self._emit(s, toks[base + j, c - 1], now)
            self._last_logits = None
            return True
        if decode_rows:
            toks, now = self._decode_once(decode_rows)
            for s in decode_rows:
                self.scheduler.publish_full_blocks(s)
            for i, s in enumerate(decode_rows):
                self._emit(s, toks[i], now)
            return True
        return bool(self.scheduler.pending)

    def run(self) -> Dict[int, np.ndarray]:
        """Drive :meth:`step` until every submitted request has
        completed; returns ``results`` (id -> generated token ids)."""
        while self.step():
            pass
        return self.results
