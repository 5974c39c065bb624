"""The serving engine: continuous batching over the paged KV cache.

Port of ``horovod_tpu/serving/engine.py`` (single device): the
scheduler re-decides the batch every step, and each step runs ONE of
three program families over *padding tiers* —

* a MIXED step packs the running decode batch plus prefill chunks
  (Sarathi-style chunked prefill: a chunk at offset k is just another
  batch row of the per-row-offset attention kernel), keyed by (batch
  tier, chunk tier);
* a DECODE step, keyed by (batch tier, page tier): the decode kernel
  reads the pools in place through the block tables, no further than the
  batch's live max-context page tier;
* a speculative VERIFY step (``ServeConfig.spec``): each decode row
  feeds its last token plus up to ``spec_k`` drafted tokens as one chunk
  row at its tail, padded to the static width ``spec_w`` and keyed by
  (batch tier, ``spec_w``, page tier); greedy accept/reject keeps the
  stream token-identical to plain decode.

Every attention call of every family runs the hand-written kernel of
``ops/flash_attention.py`` once per layer.  PyTorch runs eagerly, so
nothing is compiled per shape; the engine still books each step's
(kind, tier...) key as the JAX engine books its programs
(:meth:`ServingEngine.program_count`), and :meth:`ServingEngine.warmup`
books the whole menu, so ``program_count == warmup()`` means no step
ran outside the menu.

Also ported: the staged intake (:meth:`ServingEngine.attach_source`,
prompts device-staged by the data pipeline's ``DevicePrefetcher`` while
steps compute), KV snapshot export/import for replica migration and the
disaggregated fleet's prefill→decode handoff, the ``role="prefill"``
engine that stops each request at that handoff, and the static-batching
baseline :meth:`ServingEngine.run_static`.  The port departs from the
reference in one place: its pools are updated in place, so an export
copies only the exported chains' pages to the host (one ``index_select``
over the block axis, then one copy) and an import writes only the fresh
blocks (``index_copy_``), where the JAX engine moves the whole pool each
way.  The snapshot's bytes are the same.

Decoding is greedy (argmax of fp32 logits): batched decode over the
paged cache emits token for token what one-at-a-time full-context
decode emits, across admit/evict boundaries.

The JAX engine's lowered-program views (``lowered_decode_text``,
``lowered_mixed_text``) have no eager counterpart; their stand-ins,
:meth:`ServingEngine.decode_step_inventory` and
:meth:`ServingEngine.mixed_step_inventory`, run one step of the family
under ``torch.profiler`` and report its kernels and the page bytes it
gathered.  The decode step reads the pools in place through the paged
kernel, so it gathers nothing, where the JAX decode program gathers
every page it reads.

Tensor sharding (``ServeConfig.shards`` > 1, or ``mesh=`` a process
set): one engine per rank of the set, each over its slice of the
weights (Megatron: heads and the MLP hidden, two all-reduces a layer)
and of the pool (the kv-head dimension), where the JAX engine runs one
``shard_map`` program over the chips.  Every rank runs this host loop,
and must take the same decisions, or the all-reduces deadlock:
requests enter on the set's first rank (what the others submit is
replaced by its broadcast, so call ``submit`` on every rank with the
same arguments or on the first alone), and every step begins with one
broadcast from it — the requests submitted or drained from staging
since the last step, whether its source is done, and its clock for the
deadline shed.  Tables, refcounts and evictions then replicate, greedy
tokens come from identical logits after the all-reduces, and
request-level instruments are booked on the first rank alone.
``check_agreement`` (off; the tests turn it on) asserts each step that
the ranks took the same tokens.  :meth:`ServingEngine.export_requests`
gathers the kv-head slices into the record an unsharded engine writes,
and :meth:`ServingEngine.import_kv` slices one, so snapshots move
between sharded and unsharded engines both ways; both are collective
over the set, as is every step.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import trace
from ..common import basics
from ..common.device import resolve_device
from ..common.retry import env_float, env_int
from ..metrics import instruments as _instr
from ..models.convert import shard_params
from ..models.transformer import Transformer, TransformerConfig
from ..ops.comm_model import modeled_serve_psum_bytes
from ..parallel._mesh_utils import tensor_shard_mesh
from ..utils.logging import get_logger
from ..utils.profiler import device_kernels
from .kv_cache import (
    BlockAllocator, PagedKVState, blocks_for, make_pools, pool_bytes,
    snap_origin,
)
from .scheduler import ContinuousBatchingScheduler, Request, Sequence
from .speculative import Drafter, accept_greedy, make_drafter

try:  # numpy's bfloat16 (no JAX import); the card's machine may lack it
    from ml_dtypes import bfloat16 as _BF16
except ImportError:  # pragma: no cover - exercised with the module hidden
    _BF16 = None

_CACHE_HIT = _instr.EXEC_CACHE.labels("hit")
_CACHE_MISS = _instr.EXEC_CACHE.labels("miss")
_LAT_FIRST = _instr.SERVE_TOKEN_LATENCY.labels("first")
_LAT_INTER = _instr.SERVE_TOKEN_LATENCY.labels("inter")
_STEP_MIXED = _instr.SERVE_STEPS.labels("mixed")
_STEP_DECODE = _instr.SERVE_STEPS.labels("decode")
_STEP_SPEC = _instr.SERVE_STEPS.labels("spec")
_REQ_SUBMITTED = _instr.SERVE_REQUESTS.labels("submitted")
_REQ_COMPLETED = _instr.SERVE_REQUESTS.labels("completed")
_ALLREDUCES = _instr.COLLECTIVES.labels("allreduce", "eager")
_ALLREDUCE_BYTES = _instr.COLLECTIVE_BYTES.labels("allreduce")


def _allreduce_totals() -> Tuple[float, float]:
    """(all-reduces, payload bytes) booked in this process so far: the
    sharded steps' row-parallel sums book there."""
    return _ALLREDUCES.get(), _ALLREDUCE_BYTES.get()


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
    prefix caching (greedy outputs are bit-identical either way).
    ``spec`` turns speculative decoding on: up to ``spec_k`` tokens
    drafted by ``spec_drafter`` per decode step, verified in one chunk
    step at the static width ``spec_w`` (the next power of two >=
    ``spec_k + 1``); outputs stay bit-identical to plain decode."""

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
    #: tensor-shard the engine over this many ranks of one host (kv heads
    #: and the paged pool head-sharded, Megatron MLP; must divide
    #: num_kv_heads, num_heads and d_model*mlp_ratio); 1 = one card;
    #: ignored when an explicit mesh is passed
    shards: int = 1
    spec: bool = False
    spec_k: int = 4
    spec_drafter: str = "prompt_lookup"

    @classmethod
    def from_env(cls, **overrides) -> "ServeConfig":
        base = cls(**overrides)
        fields = dataclasses.asdict(base)
        # each knob spelled out, so the env pass sees its read
        if "block_size" not in overrides:
            fields["block_size"] = env_int("HVD_TPU_SERVE_BLOCK_SIZE",
                                           base.block_size)
        if "num_blocks" not in overrides:
            fields["num_blocks"] = env_int("HVD_TPU_SERVE_NUM_BLOCKS",
                                           base.num_blocks)
        if "token_budget" not in overrides:
            fields["token_budget"] = env_int("HVD_TPU_SERVE_TOKEN_BUDGET",
                                             base.token_budget)
        if "watermark" not in overrides:
            fields["watermark"] = env_int("HVD_TPU_SERVE_WATERMARK",
                                          base.watermark)
        if "prefill_chunk" not in overrides:
            fields["prefill_chunk"] = env_int("HVD_TPU_SERVE_PREFILL_CHUNK",
                                              base.prefill_chunk)
        if "shards" not in overrides:
            fields["shards"] = env_int("HVD_TPU_SERVE_SHARDS", base.shards)
        if "spec_k" not in overrides:
            fields["spec_k"] = env_int("HVD_TPU_SERVE_SPEC_K", base.spec_k)
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
        if "spec_drafter" not in overrides:
            fields["spec_drafter"] = os.environ.get(
                "HVD_TPU_SERVE_SPEC_DRAFTER", base.spec_drafter)
        return cls(**fields)


def _page_tensor(page, dtype: torch.dtype, shape: tuple) -> torch.Tensor:
    """One ``kvsnap/1`` page (a numpy array; bf16 as ``ml_dtypes``
    bfloat16 or 2-byte integer bits) as a host tensor of the pool's
    dtype, or ``ValueError`` when its element size, kind or shape
    differs from the pool's page."""
    arr = np.asarray(page)
    size = torch.empty((), dtype=dtype).element_size()
    if arr.dtype.itemsize != size or tuple(arr.shape) != tuple(shape):
        raise ValueError(
            f"snapshot page {arr.dtype}{tuple(arr.shape)} does not fit "
            f"this pool's {dtype}{tuple(shape)} pages")
    if dtype == torch.bfloat16:
        if arr.dtype.kind not in "uiV" and arr.dtype.name != "bfloat16":
            raise ValueError(
                f"snapshot page of {arr.dtype} cannot hold bfloat16 bits")
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    want = torch.empty((), dtype=dtype).numpy().dtype
    if arr.dtype != want:
        raise ValueError(
            f"snapshot page of {arr.dtype} does not match this pool's "
            f"{want}")
    return torch.from_numpy(np.ascontiguousarray(arr))


def _host_pages(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy.  numpy has no bfloat16: bf16 comes out as
    an ``ml_dtypes.bfloat16`` view of its bits (the JAX package's page
    dtype, so its engine assigns the values it meant), or as ``uint16``
    bits where ``ml_dtypes`` is not installed."""
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy()
        return bits.view(np.uint16 if _BF16 is None else _BF16)
    return t.numpy()


class ServingEngine:
    """Continuous-batching inference over one :class:`Transformer`.

    ``params`` is the model's state dict (``init_params`` /
    ``params_from_flax``), adopted without a copy when it already lies on
    ``device``.  The config must be causal with attention_impl 'dot' or
    'flash'; GQA and sliding windows shrink the cache and the decode
    reads natively.  ``device`` defaults to the first CUDA card and
    raises without one; ``device="cpu"`` runs the kernels' plain
    versions (the tests).  The KV pools are updated in place.

    ``drafter`` overrides ``ServeConfig.spec_drafter`` (and turns
    speculation on).  ``role="prefill"`` makes the disaggregated fleet's
    prefill tier: each request stops at the step its prompt completes
    and its first token emits, and parks an exported ``kvsnap/1`` record
    in :attr:`handoffs`; such an engine never runs a decode or verify
    step.

    ``mesh`` (a process set, as from
    :func:`~horovod_tpu_torch.parallel.tensor_shard_mesh`) or
    ``ServeConfig.shards`` > 1 tensor-shards the engine over the set's
    ranks (the module docstring): ``params`` is the full tree, and each
    rank keeps copies of its slices (``models.convert.shard_params``),
    so the caller can free the tree."""

    def __init__(self, cfg: TransformerConfig, params, *,
                 serve: Optional[ServeConfig] = None, device=None,
                 mesh=None,
                 drafter: Optional[Drafter] = None,
                 role: str = "both",
                 clock=time.perf_counter):
        if cfg.attention_impl not in ("dot", "flash") or not cfg.causal:
            raise ValueError(
                "serving requires a causal 'dot' or 'flash' config, got "
                f"attention_impl={cfg.attention_impl!r} causal={cfg.causal}")
        if role not in ("both", "prefill"):
            raise ValueError(
                f"role must be 'both' or 'prefill', got {role!r}")
        self.serve_cfg = serve = serve or ServeConfig.from_env()
        shards = mesh.size() if mesh is not None else serve.shards
        if shards > 1:
            hidden = cfg.d_model * cfg.mlp_ratio
            if (cfg.num_heads % shards or cfg.kv_heads % shards
                    or hidden % shards):
                raise ValueError(
                    f"shards ({shards}) must divide num_heads "
                    f"({cfg.num_heads}), num_kv_heads ({cfg.kv_heads}) and "
                    f"d_model*mlp_ratio ({hidden}) — kv heads are the "
                    f"pool's shard seam")
            if mesh is None:
                mesh = tensor_shard_mesh("tp", shards)
        #: the process set the engine is sharded over (None: one card)
        self.mesh = mesh if shards > 1 else None
        self.shards = shards
        #: this rank's slice index in the set
        self.shard_rank = 0
        if self.mesh is not None:
            self.shard_rank = self.mesh.rank_in_set(basics.rank())
        #: the set's first rank: it takes requests in and books the
        #: request-level instruments
        self.lead = self.shard_rank == 0
        #: assert every step that the ranks took the same tokens
        self.check_agreement = False
        #: per-rank bytes the sharded steps' all-reduces streamed so far
        #: (modeled; 0 unsharded)
        self.shard_psum_bytes = 0
        self._inbox: List[Request] = []
        self.device = resolve_device(device)
        self.cfg = cfg
        self._clock = clock
        self.role = role
        #: rid -> (stream, snap, arrival) parked at the handoff boundary
        #: for the fleet router (prefill role only)
        self.handoffs: Dict[int, tuple] = {}
        #: replica name stamped into every export's ``source`` tag
        self.snap_source: Optional[str] = None
        if self.mesh is not None:
            params = shard_params(params, cfg, self.shard_rank, shards)
        self.model = Transformer(
            dataclasses.replace(cfg, shard_axis=self.mesh), params={
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
        # speculative decoding: k drafted tokens verify as ONE chunk row
        # of width k+1 at the sequence tail, padded to the static spec_w
        self._drafter: Optional[Drafter] = drafter
        if self._drafter is None and serve.spec:
            self._drafter = make_drafter(serve.spec_drafter)
        if self.role == "prefill":
            self._drafter = None  # the prefill tier never decodes
        self.spec_w = 0
        if self._drafter is not None:
            if serve.spec_k < 1:
                raise ValueError(
                    f"spec_k must be >= 1 with speculation on, got "
                    f"{serve.spec_k}")
            self.spec_w = 1 << int(serve.spec_k).bit_length()  # >= k+1
        #: lifetime speculative counters
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_rolled_back_tokens = 0
        self.spec_steps = 0
        self.spec_verified_rows = 0
        self.num_blocks = num_blocks
        # each rank holds its kv heads' slice of EVERY block: tables,
        # refcounts and evictions replicate
        self.k_pool, self.v_pool = make_pools(
            cfg.num_layers, num_blocks, bs, cfg.kv_heads // shards,
            cfg.head_dim, cfg.dtype, device=self.device)
        self.pool_bytes = pool_bytes(
            cfg.num_layers, num_blocks, bs, cfg.kv_heads, cfg.head_dim,
            cfg.dtype)
        #: device memory one rank gives the K+V pools
        self.pool_bytes_per_shard = pool_bytes(
            cfg.num_layers, num_blocks, bs, cfg.kv_heads, cfg.head_dim,
            cfg.dtype, shards=shards)
        _instr.SERVE_KV_BLOCKS_PER_SHARD.set(num_blocks)
        self.allocator = BlockAllocator(
            num_blocks, bs, prefix_cache=serve.prefix_cache)
        self.scheduler = ContinuousBatchingScheduler(
            self.allocator, token_budget=serve.token_budget,
            watermark=serve.watermark, max_decode_batch=max_batch,
            max_seq_len=cfg.max_seq_len)
        # queue depth = scheduler pending + staged-but-undrained
        self.scheduler.staged_depth = lambda: len(self._staging_meta)
        #: intake gate: False = draining (submit/attach_source reject,
        #: in-flight work keeps stepping)
        self.accepting = True
        self.results: Dict[int, np.ndarray] = {}
        self._ids_seen: set = set()
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
        #: (kind, tier...) step keys booked so far (program_count)
        self._progs: Dict[tuple, bool] = {}
        self._staging = None
        self._staging_meta: collections.deque = collections.deque()
        self._source_done = True
        #: chunk tokens actually computed by prefill (prefix-cache hits
        #: and pad columns excluded)
        self.prefill_tokens_computed = 0
        #: steps run (mixed + decode + verify); each runs the attention
        #: kernel once per layer
        self.steps = 0

    # -- the tiered program families -----------------------------------------

    def _mixed_step(self, tables, lens, chunk_lens, tokens, pages=None):
        """One mixed chunked-prefill + decode step: row i writes and
        attends ``chunk_lens[i]`` new tokens at global offset ``lens[i]``
        (a decode row is a chunk of 1, a verify row a chunk of k+1).
        Returns the greedy token at EVERY position, (B, C) on device.
        ``pages`` bounds the unwindowed gather (None = the whole
        table)."""
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

    def _book_program(self, kind: str, *dims) -> None:
        """Book one step's (kind, tier...) key into the executable-cache
        hit/miss counters, as the JAX engine books its programs."""
        key = (kind,) + dims
        if key in self._progs:
            _CACHE_HIT.inc()
        else:
            _CACHE_MISS.inc()
            self._progs[key] = True

    def _book_psum_bytes(self, batch_tier: int, q_len: int) -> None:
        """Book one sharded step's modeled per-rank all-reduce stream
        (:func:`~horovod_tpu_torch.ops.comm_model.
        modeled_serve_psum_bytes`) into ``shard_psum_bytes`` and
        ``SERVE_SHARD_PSUM_BYTES``."""
        if self.shards <= 1:
            return
        m = modeled_serve_psum_bytes(
            batch_tier, q_len, self.cfg.d_model, self.cfg.num_layers,
            self.shards, dtype=self.cfg.dtype)
        self.shard_psum_bytes += m["stream_bytes"]
        _instr.SERVE_SHARD_PSUM_BYTES.inc(m["stream_bytes"])

    def _agree(self, out: np.ndarray) -> None:
        """With ``check_agreement`` on a sharded engine: raise unless
        every rank of the set took the first rank's tokens this step."""
        if self.mesh is None or not self.check_agreement:
            return
        mine = torch.from_numpy(np.ascontiguousarray(out).astype(np.int64))
        first = mine.to(self.device)
        # contract-ok: collectives -- every rank of the set ends each sharded step here (the JAX engine's step is one SPMD program, with no host collective to route)
        dist.broadcast(first, self.mesh.ranks[0], group=self.mesh.group)
        if not torch.equal(first.cpu(), mine):
            raise RuntimeError(
                f"shard rank {self.shard_rank} took other tokens than the "
                f"set's first rank this step")

    @property
    def program_count(self) -> int:
        """Distinct (kind, tier...) step keys booked so far."""
        return len(self._progs)

    def decode_step_inventory(self, batch_tier: Optional[int] = None,
                              pages: Optional[int] = None) -> dict:
        """Stand-in for the JAX engine's ``lowered_decode_text``: run
        ONE decode step (smallest tiers by default) with all-zero block
        tables, so that every write lands in the trash block and no
        sequence's pages change, under ``torch.profiler``.  Returns
        ``{"kernels": {name: {"launches", "device_ms"}}, "gather_bytes",
        "collectives": []}``: the step's device kernels (on the CPU, the
        profiler's CPU events stand in for them), and the K/V bytes
        :meth:`PagedKVState.gather` copied — 0 here, since the decode
        kernel reads the pools in place (on the CPU its plain version
        gathers inside the kernel's stand-in, which is not counted); and
        ``collectives``, one ``{"op": "all_reduce", "payload_bytes"}``
        per all-reduce the step ran — none on one card, two a layer on
        a sharded engine, whose every rank must run the inventory
        together."""
        bt = batch_tier or self.decode_tiers[0]
        pt = pages or self.page_tiers[0]
        dev = self.device
        tables = torch.zeros((bt, self.max_blocks_per_seq), dtype=torch.long,
                             device=dev)
        ones = torch.ones((bt,), dtype=torch.int32, device=dev)
        last = torch.zeros((bt,), dtype=torch.long, device=dev)
        return self._step_inventory(
            lambda: self._decode_step(tables, ones, last, pt))

    def mixed_step_inventory(self, batch_tier: Optional[int] = None,
                             chunk_tier: Optional[int] = None,
                             pages: Optional[int] = None) -> dict:
        """Stand-in for the JAX engine's ``lowered_mixed_text``: ONE
        mixed step (smallest batch and chunk tiers by default;
        ``pages=None`` = the prefill-mixed ``max_blocks``-wide gather),
        as :meth:`decode_step_inventory` runs its step.  Its
        ``gather_bytes`` is ``batch_tier ×
        modeled_decode_read_bytes(...)["gathered_bytes"]`` at the step's
        page bound."""
        bt = batch_tier or self.decode_tiers[0]
        c = chunk_tier or self.chunk_tiers[0]
        dev = self.device
        tables = torch.zeros((bt, self.max_blocks_per_seq), dtype=torch.long,
                             device=dev)
        zeros = torch.zeros((bt,), dtype=torch.int32, device=dev)
        ones = torch.ones((bt,), dtype=torch.int32, device=dev)
        tokens = torch.zeros((bt, c), dtype=torch.long, device=dev)
        return self._step_inventory(
            lambda: self._mixed_step(tables, zeros, ones, tokens, pages))

    def _step_inventory(self, run) -> dict:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        last_logits = self._last_logits
        if cuda:
            torch.cuda.synchronize(self.device)
        before = PagedKVState.gather_bytes
        red = _allreduce_totals()
        with torch.inference_mode(), profile(activities=acts) as prof:
            run()
            if cuda:
                torch.cuda.synchronize(self.device)
        gathered = PagedKVState.gather_bytes - before
        calls, nbytes = (a - b for a, b in zip(_allreduce_totals(), red))
        calls = int(calls)
        payload = int(nbytes) // max(calls, 1)
        self._last_logits = last_logits
        events = (device_kernels(prof) if cuda else
                  [e for e in prof.events() if e.device_type == DeviceType.CPU])
        kernels: Dict[str, dict] = {}
        for e in events:
            k = kernels.setdefault(e.name, {"launches": 0, "device_ms": 0.0})
            k["launches"] += 1
            k["device_ms"] += (e.time_range.end - e.time_range.start) / 1e3
        return {"kernels": kernels, "gather_bytes": gathered,
                "collectives": [{"op": "all_reduce",
                                 "payload_bytes": payload}] * calls}

    def warmup(self) -> int:
        """Build the kernel library (on a card), book the WHOLE tier menu
        — every (batch tier, chunk tier) mixed key, every (batch tier,
        page tier) decode key and, with speculation on, every (batch
        tier, ``spec_w``, page tier) verify key: ``|decode_tiers| ×
        (|chunk_tiers| + |page_tiers| + spec·|page_tiers|)``, the JAX
        engine's program menu — and run one step of each family at its
        smallest tiers, with all-zero block tables so every write lands
        in the trash block.  A ``role="prefill"`` engine books the mixed
        chunk menu only (its requests leave at the handoff).  Returns
        the number of keys booked."""
        if self.device.type == "cuda":
            from ..ops import _build

            _build.build_all()
        before = len(self._progs)
        for bt in self.decode_tiers:
            for c in self.chunk_tiers:
                self._book_program("mixed", bt, c, None)
            if self.role == "prefill":
                continue
            for pt in self.page_tiers:
                self._book_program("decode", bt, pt)
            if self._drafter is not None:
                for pt in self.page_tiers:
                    self._book_program("mixed", bt, self.spec_w, pt)
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
            if self.role != "prefill":
                self._decode_step(tables, ones, torch.zeros(
                    (bt,), dtype=torch.long, device=dev), pt)
            if self._drafter is not None:
                self._mixed_step(tables, zeros, ones, torch.zeros(
                    (bt, self.spec_w), dtype=torch.long, device=dev), pt)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return len(self._progs) - before

    # -- request intake ------------------------------------------------------

    def _validate_request(self, prompt_len: int, max_new_tokens: int,
                          rid: Optional[int] = None) -> None:
        who = "" if rid is None else f"request {rid}: "
        if prompt_len < 1:
            raise ValueError(f"{who}empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"{who}max_new_tokens must be >= 1 (the prefill step "
                f"always emits one token), got {max_new_tokens}")
        if prompt_len + max_new_tokens > self.cfg.max_seq_len:
            raise ValueError(
                f"{who}prompt ({prompt_len}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len "
                f"{self.cfg.max_seq_len}")

    def submit(self, prompt, max_new_tokens: int, *, eos_id=None,
               arrival: Optional[float] = None,
               deadline_s: Optional[float] = None,
               trace_id: Optional[str] = None,
               spec_k: Optional[int] = None) -> int:
        """Enqueue one request; returns its id (key into ``results``).
        ``spec_k`` overrides the engine's speculative lookahead for this
        request (clamped to the engine's; 0 = off, None = inherit)."""
        if not self.accepting:
            raise RuntimeError(
                "engine is draining (accepting=False); submit rejected")
        if spec_k is not None and spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self._validate_request(len(prompt), max_new_tokens)
        if deadline_s is None:
            deadline_s = self.serve_cfg.deadline_s
        req = Request(
            id=self._next_id, prompt=prompt,
            max_new_tokens=int(max_new_tokens), eos_id=eos_id,
            arrival=self._clock() if arrival is None else arrival,
            deadline_s=deadline_s if deadline_s and deadline_s > 0
            else None, trace_id=trace_id, spec_k=spec_k)
        self._next_id += 1
        if self.mesh is not None:
            # enters at the next step, from the set's first rank
            self._inbox.append(req)
            if self.lead:
                _REQ_SUBMITTED.inc()
            return req.id
        self._ids_seen.add(req.id)
        if req.deadline_s:
            self._any_deadline = True
        self.scheduler.submit(Sequence(req=req, context=prompt))
        _REQ_SUBMITTED.inc()
        return req.id

    def _stage_rows(self, requests: Iterable[Request]):
        """Generator the staging prefetcher consumes: each prompt padded
        to its prefill tier; metadata rides a side deque in the same
        (FIFO) order."""
        for req in requests:
            # the raise propagates to the consumer via the prefetcher
            self._validate_request(len(req.prompt), req.max_new_tokens,
                                   rid=req.id)
            row = np.zeros(
                (_tier_for(self.prefill_tiers, len(req.prompt)),), np.int32)
            row[:len(req.prompt)] = req.prompt
            self._staging_meta.append(req)
            yield (row,)

    def attach_source(self, requests: Iterable[Request],
                      depth: Optional[int] = None) -> None:
        """Open-loop intake: stage ``requests`` (an iterator that may
        block until each request's arrival) onto the engine's device
        through the data pipeline's ``DevicePrefetcher`` while steps
        compute.  On a sharded engine only the set's first rank stages
        (its steps broadcast what it drains); the other ranks' call just
        marks a source attached, and their ``requests`` go unread."""
        from ..data.prefetch import DevicePrefetcher

        if not self.accepting:
            raise RuntimeError(
                "engine is draining (accepting=False); source rejected")
        if self._staging is not None and not self._source_done:
            raise RuntimeError("a request source is already attached")
        if not self.lead:
            self._source_done = False
            return
        gen = self._stage_rows(requests)
        if self._staging is None:
            self._staging = DevicePrefetcher(gen, depth=depth,
                                             device=self.device,
                                             source_kind="serving")
        else:
            self._staging.restart(gen)
        self._source_done = False

    def _drain_staging(self, block: bool) -> None:
        if self._staging is None or self._source_done:
            return
        while True:
            item = self._staging.poll(block=block)
            block = False  # at most one blocking wait per drain
            if item is self._staging.EXHAUSTED:
                self._source_done = True
                self.scheduler._book()
                return
            if item is None:
                self.scheduler._book()  # refresh the staged-depth gauge
                return
            req = self._staging_meta.popleft()
            if req.deadline_s is None and self.serve_cfg.deadline_s > 0:
                req.deadline_s = self.serve_cfg.deadline_s
            if req.deadline_s and not req.arrival:
                # a deadline runs from arrival: a source that left it at
                # 0.0 starts the clock when the request surfaces
                req.arrival = self._clock()
            if req.deadline_s:
                self._any_deadline = True
            # caller-chosen ids share `results` with submit()'s counter
            if req.id in self._ids_seen:
                raise ValueError(
                    f"sourced request id {req.id} already in use")
            self._ids_seen.add(req.id)
            self._next_id = max(self._next_id, req.id + 1)
            _REQ_SUBMITTED.inc()
            if self.mesh is not None:
                # the row stays staged on this rank; every rank
                # assembles chunks of it on the host
                self._inbox.append(req)
                continue
            seq = Sequence(req=req, context=req.prompt)
            seq.staged = item[0]
            self.scheduler.submit(seq)

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

    def _chunk_row(self, s: Sequence, c: int, width: int):
        """One prefill chunk's tokens — ``context[prefilled:prefilled+c]``
        — padded to the chunk tier ``width``.  The device-staged row is
        used only when it IS the chunk (the whole prompt, staged at
        exactly the step's width); any other chunk assembles on the host
        (prompt tokens are KBs; the K/V is what is big)."""
        row = s.staged
        if row is not None and s.prefilled == 0 and \
                c == len(s.context) and row.shape[0] == width:
            return row
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
        plus ``chunk_sel`` — the one step both the engine loop and the
        static baseline assemble through.  Row order: decode rows first,
        chunk rows after.  Returns the (batch tier, width) per-position
        argmax grid (host) and the emission time."""
        n = len(decode_rows) + len(chunk_sel)
        bt = self._batch_tier(n)
        width = _tier_for(
            self.chunk_tiers, max([c for _, c in chunk_sel], default=1))
        rows = []
        lens_list = []
        chunk_lens = np.zeros((bt,), np.int32)
        for i, s in enumerate(decode_rows):
            host = np.zeros((width,), np.int64)
            host[0] = s.generated[-1]
            rows.append(host)
            lens_list.append(s.length - 1)
            chunk_lens[i] = 1
        for j, (s, c) in enumerate(chunk_sel):
            rows.append(self._chunk_row(s, c, width))
            lens_list.append(s.prefilled)
            chunk_lens[len(decode_rows) + j] = c
        rows.extend([np.zeros((width,), np.int64)] * (bt - n))
        if all(isinstance(r, np.ndarray) for r in rows):
            tokens = torch.from_numpy(np.stack(rows)).to(self.device)
        else:  # device-staged rows in the mix
            tokens = torch.stack([
                torch.from_numpy(r).to(self.device)
                if isinstance(r, np.ndarray) else r.to(self.device).long()
                for r in rows])
        tables, lens = self._tables_lens(
            decode_rows + [s for s, _ in chunk_sel], bt, lens_list)
        self._book_program("mixed", bt, width, None)
        self._book_psum_bytes(bt, width)
        tracing = trace.enabled()
        t0 = trace.now() if tracing else 0.0
        with torch.inference_mode():
            next_tok = self._mixed_step(
                tables, lens, torch.from_numpy(chunk_lens).to(self.device),
                tokens)
        out = next_tok.cpu().numpy()  # device sync: the step's true extent
        self._agree(out)
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

    def _page_tier(self, seqs: List[Sequence], extra=lambda s: 0) -> int:
        """The batch's live page tier (the whole table when windowed)."""
        if self.cfg.window is not None:
            return self.max_blocks_per_seq
        need = max(blocks_for(s.length + extra(s), self.serve_cfg.block_size)
                   for s in seqs)
        return _tier_for(self.page_tiers, need)

    def _decode_once(self, seqs: List[Sequence]):
        """One decode step over ``seqs`` (the newest token's K/V is
        written by THIS step, at position length - 1); the unwindowed
        decode reads no further than the batch's live page tier."""
        bt = self._batch_tier(len(seqs))
        cache_lens = [s.length - 1 for s in seqs]
        pages = self._page_tier(seqs)
        tables, lens = self._tables_lens(seqs, bt, cache_lens)
        last = np.zeros((bt,), np.int64)
        last[:len(seqs)] = [s.generated[-1] for s in seqs]
        self._book_program("decode", bt, pages)
        self._book_psum_bytes(bt, 1)
        tracing = trace.enabled()
        t0 = trace.now() if tracing else 0.0
        with torch.inference_mode():
            next_tok = self._decode_step(
                tables, lens, torch.from_numpy(last).to(self.device), pages)
        out = next_tok.cpu().numpy()  # device sync: the step's true extent
        self._agree(out)
        if tracing:
            t1 = trace.now()
            self._last_step = ("decode", t0, t1)
            trace.add_span("serve.step", t0, t1, kind="decode",
                           batch=len(seqs), rids=[s.req.id for s in seqs])
        _STEP_DECODE.inc()
        self.steps += 1
        return out, self._clock()

    # -- speculative decode --------------------------------------------------

    def _propose_draft(self, s: Sequence) -> None:
        """Ask the drafter for this sequence's next-step lookahead: the
        per-request ``spec_k`` clamps below the engine's, and the draft
        is capped so the verify step never writes past ``max_seq_len``
        or drafts tokens the budget would discard.  An empty draft
        means the row decodes plain."""
        k = s.req.spec_k if s.req.spec_k is not None \
            else self.serve_cfg.spec_k
        remaining = s.req.max_new_tokens - (
            len(s.generated) + (len(s.context) - len(s.req.prompt)))
        k = min(int(k), self.serve_cfg.spec_k,
                self.cfg.max_seq_len - s.length - 1, remaining - 1)
        if k < 1:
            s.draft = []
            return
        stream = s.context if not s.generated else np.concatenate(
            [s.context, np.asarray(s.generated, np.int32)])
        s.draft = [int(t) for t in self._drafter.draft(stream, k)][:k]

    def _run_spec_step(self, rows: List[Sequence]):
        """One verify step over the decode batch: row i feeds ``[last
        token] + draft`` as a chunk of ``1 + len(draft)`` at its tail
        offset (``lens = length - 1``, as plain decode), padded to the
        static width ``spec_w``; draft-free rows ride as chunks of 1.
        The gather is page-tiered over the live context plus the
        speculative tail."""
        bt = self._batch_tier(len(rows))
        width = self.spec_w
        tokens_host = np.zeros((bt, width), np.int64)
        chunk_lens = np.zeros((bt,), np.int32)
        lens_list = []
        for i, s in enumerate(rows):
            fed = [s.generated[-1]] + s.draft
            tokens_host[i, :len(fed)] = fed
            chunk_lens[i] = len(fed)
            lens_list.append(s.length - 1)
        pages = self._page_tier(rows, extra=lambda s: len(s.draft))
        tables, lens = self._tables_lens(rows, bt, lens_list)
        self._book_program("mixed", bt, width, pages)
        self._book_psum_bytes(bt, width)
        tracing = trace.enabled()
        t0 = trace.now() if tracing else 0.0
        with torch.inference_mode():
            next_tok = self._mixed_step(
                tables, lens, torch.from_numpy(chunk_lens).to(self.device),
                torch.from_numpy(tokens_host).to(self.device), pages)
        out = next_tok.cpu().numpy()  # device sync: the step's true extent
        self._agree(out)
        if tracing:
            t1 = trace.now()
            self._last_step = ("spec", t0, t1)
            trace.add_span("serve.step", t0, t1, kind="spec",
                           batch=len(rows),
                           drafted=int(sum(len(s.draft) for s in rows)),
                           rids=[s.req.id for s in rows])
        _STEP_SPEC.inc()
        self.spec_steps += 1
        self.steps += 1
        return out, self._clock()

    def _settle_spec(self, s: Sequence, row_argmax, now: float) -> List[int]:
        """Greedy accept/reject one verify row, then roll the speculative
        KV tail back: the sequence keeps the blocks its post-acceptance
        length occupies (``truncate_tail`` releases the rest through the
        refcount path).  Positions past the accept point inside the
        surviving tail block hold rejected-draft K/V that ``lens`` masks
        and the next step overwrites.  Returns the emitted tokens."""
        k = len(s.draft)
        emitted, m = accept_greedy(s.draft, row_argmax[:k + 1])
        rolled = k - m
        s.spec_drafted += k
        s.spec_accepted += m
        self.spec_drafted_tokens += k
        self.spec_accepted_tokens += m
        self.spec_rolled_back_tokens += rolled
        self.spec_verified_rows += 1
        _instr.SERVE_SPEC_DRAFTED.inc(k)
        _instr.SERVE_SPEC_ACCEPTED.inc(m)
        if rolled:
            _instr.SERVE_SPEC_ROLLED_BACK.inc(rolled)
        new_len = s.length + len(emitted)
        s.blocks = self.allocator.truncate_tail(s.blocks, new_len)
        s.draft = []
        if trace.enabled() and self._last_step is not None:
            t0, t1 = self._last_step[1], self._last_step[2]
            trace.add_span("serve.spec_verify", t0, t1, rid=s.req.id,
                           drafted=k, accepted=m, trace=s.req.trace_id)
            if rolled:
                trace.event("serve.spec_rollback", rid=s.req.id,
                            tokens=rolled, trace=s.req.trace_id)
        return emitted

    # -- token emission ------------------------------------------------------

    def _observe_token(self, seq: Sequence, token: int, now: float) -> None:
        seq.generated.append(int(token))
        if self.token_log is not None:
            self.token_log.append((seq.req.id, now, seq.req.arrival))
        if seq.first_token_at is None:
            seq.first_token_at = now
            if self.lead:
                _LAT_FIRST.observe(now - seq.req.arrival)
            trace.event("serve.first_token", rid=seq.req.id,
                        ttft=now - seq.req.arrival, trace=seq.req.trace_id)
            if self._last_step is not None and \
                    self._last_step[0] in ("decode", "spec"):
                trace.add_span("serve.first_decode", self._last_step[1],
                               self._last_step[2], rid=seq.req.id,
                               trace=seq.req.trace_id)
        elif seq.last_token_at is not None:
            # after an eviction the gap includes the requeue wait and
            # the re-prefill — the stall the user sees
            if self.lead:
                _LAT_INTER.observe(now - seq.last_token_at)
        seq.last_token_at = now

    def _emit(self, seq: Sequence, token: int, now: float) -> None:
        self._observe_token(seq, token, now)
        if seq.done:
            trace.event("serve.finish", rid=seq.req.id,
                        tokens=len(seq.generated), trace=seq.req.trace_id)
            if seq.spec_drafted and self.lead:
                _instr.SERVE_SPEC_ACCEPT_RATE.observe(
                    seq.spec_accepted / seq.spec_drafted)
            self.scheduler.finish(seq)
            self.results[seq.req.id] = self._partial_result(seq)
            if self.lead:
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
            if self.lead:
                _instr.SERVE_REQUESTS.labels("expired").inc()
        self.scheduler.shed.clear()

    def cancel_all(self) -> None:
        """Abort every request this engine still holds — running,
        pending, shed or device-staged — publishing each one's partial
        result (often empty).  The staging producer stops first (it
        appends to the staged metadata concurrently)."""
        sched = self.scheduler
        self._finalize_shed()
        for seq in list(sched.running):
            sched.finish(seq)
            self.results.setdefault(seq.req.id, self._partial_result(seq))
        for seq in list(sched.pending):
            self.results.setdefault(seq.req.id, self._partial_result(seq))
        sched.pending.clear()
        if self._staging is not None:
            self._staging.close()
        for req in list(self._staging_meta) + self._inbox:
            self.results.setdefault(req.id, np.zeros((0,), np.int32))
        self._staging_meta.clear()
        self._inbox = []
        self._source_done = True
        sched._book()

    # -- KV snapshots: migration and the prefill->decode handoff -------------

    def _chain_pages(self, chains: Dict[int, List[int]]) -> Dict[int, list]:
        """Host (K, V) pages of every block in ``chains`` (rid -> block
        ids): ONE ``index_select`` over the block axis of each pool for
        the union of the chains, then one device-to-host copy; each
        page is a (num_layers, block_size, H_kv, D) view of it."""
        if not chains:
            return {}
        order = sorted({b for bl in chains.values() for b in bl})
        at = {b: i for i, b in enumerate(order)}
        idx = torch.tensor(order, dtype=torch.long, device=self.device)
        with torch.inference_mode():
            sel = torch.stack([self.k_pool.index_select(1, idx),
                               self.v_pool.index_select(1, idx)])
            if self.mesh is not None:
                # the set's kv-head slices, in rank order: the record
                # an unsharded engine writes
                sel = sel.contiguous()
                parts = [torch.empty_like(sel) for _ in range(self.shards)]
                # contract-ok: collectives -- export/import run on every rank of the set (the JAX engine gathers the head slices inside its one SPMD program)
                dist.all_gather(parts, sel, group=self.mesh.group)
                sel = torch.cat(parts, dim=-2)
            # (2, n, L, bs, H, D); stack and index_select copied, so no
            # page aliases the pools
            host = sel.transpose(1, 2).contiguous()
            if host.is_cuda:
                # into page-locked memory: a DMA at the link's rate (a
                # pageable destination is first-touched page by page)
                dev, host = host, torch.empty(host.shape, dtype=host.dtype,
                                              pin_memory=True)
                host.copy_(dev)
        pages = _host_pages(host)
        return {rid: [(pages[0, at[b]], pages[1, at[b]]) for b in bl]
                for rid, bl in chains.items()}

    def export_requests(self, rids: Optional[Iterable[int]] = None
                        ) -> Dict[int, tuple]:
        """Snapshot in-flight requests' recoverable state: ``{rid:
        (tokens_so_far, snap, arrival)}`` where ``tokens_so_far`` is the
        full verified stream (prompt, tokens folded into the context by
        evictions, tokens generated since) and ``snap`` (or None) the
        ``kvsnap/1`` dict of the stream's full, written blocks with
        their pages (:meth:`BlockAllocator.export_blocks`).  Only
        verified positions export (the ``tokens_in_cache`` invariant),
        so an importer's resumed decode is bit-identical.  Unlike the
        JAX engine, which pulls the whole pool to the host, only the
        exported chains' pages are copied."""
        want = set(rids) if rids is not None else None
        bs = self.serve_cfg.block_size
        found = []
        chains: Dict[int, List[int]] = {}
        for seq in list(self.scheduler.running) + \
                list(self.scheduler.pending):
            rid = seq.req.id
            if want is not None and rid not in want:
                continue
            stream = seq.context if not seq.generated else np.concatenate(
                [seq.context, np.asarray(seq.generated, np.int32)])
            stream = np.asarray(stream, np.int32)
            n_full = min(seq.tokens_in_cache // bs, len(seq.blocks))
            if n_full > 0 and self.allocator.prefix_cache:
                chains[rid] = list(seq.blocks[:n_full])
            found.append((seq, stream))
        pages = self._chain_pages(chains)
        out: Dict[int, tuple] = {}
        for seq, stream in found:
            rid = seq.req.id
            snap = None
            if rid in chains:
                n_full = len(chains[rid])
                snap = self.allocator.export_blocks(
                    chains[rid], stream[:n_full * bs], pages[rid],
                    source=self.snap_source)
            out[rid] = (stream, snap, seq.req.arrival)
        # staged or not yet entered: prompt-only (cold)
        for req in list(self._staging_meta) + self._inbox:
            if want is None or req.id in want:
                out[req.id] = (np.asarray(req.prompt, np.int32), None,
                               req.arrival)
        return out

    def import_kv(self, snap: dict) -> int:
        """Re-register a migrated block chain in this engine's allocator
        and pools (the warm path).  Every page is checked against the
        pool's element size and page shape, and the chain hashes are
        verified, before any state changes (``ValueError`` otherwise);
        index hits cost nothing; only the fresh blocks' pages are
        written (``index_copy_``).  The chain then parks on the
        prefix-cache LRU, so the re-submitted request's admission
        matches it.  Returns the number of matchable blocks."""
        cfg, bs = self.cfg, self.serve_cfg.block_size
        shape = (cfg.num_layers, bs, cfg.kv_heads, cfg.head_dim)
        h_local = cfg.kv_heads // self.shards
        h0, h1 = self.shard_rank * h_local, (self.shard_rank + 1) * h_local
        pages = snap.get("pages") if isinstance(snap, dict) else None
        host = None
        if pages:
            try:
                host = [(_page_tensor(kp, self.k_pool.dtype, shape),
                         _page_tensor(vp, self.v_pool.dtype, shape))
                        for kp, vp in pages]
            except ValueError as e:
                raise ValueError(f"{e}{snap_origin(snap)}") from None
            if len(host) != len(snap.get("hashes") or ()):
                raise ValueError(
                    f"snapshot carries {len(host)} pages for "
                    f"{len(snap.get('hashes') or ())} blocks"
                    f"{snap_origin(snap)}")
        blocks, fresh = self.allocator.import_blocks(snap)
        try:
            if fresh:
                if host is None:
                    raise ValueError(
                        "snapshot carries no pages but its chain is not "
                        "fully cached here — cannot warm-import"
                        + snap_origin(snap))
                idx = torch.tensor([b for _i, b in fresh], dtype=torch.long,
                                   device=self.device)
                cuda = self.device.type == "cuda"
                for pool, j in ((self.k_pool, 0), (self.v_pool, 1)):
                    # this rank's kv-head slice of each full page
                    pages_j = [host[i][j][:, :, h0:h1] for i, _b in fresh]
                    # (L, n_fresh, bs, H, D), staged in page-locked memory
                    # on a card so the copy runs at the link's rate
                    src = torch.empty(
                        (shape[0], len(fresh), bs, h1 - h0, shape[3]),
                        dtype=pool.dtype,
                        pin_memory=cuda)
                    torch.stack(pages_j, dim=1, out=src)
                    pool.index_copy_(1, idx,
                                     src.to(self.device, non_blocking=cuda))
        except Exception:
            # never leave a registered-but-pages-unwritten block matchable
            for _i, b in fresh:
                if b in self.allocator._meta:
                    self.allocator._drop_cache_entry(b)
            self.allocator.free(blocks)
            raise
        self.allocator.free(blocks)  # park the chain, matchable
        return len(blocks)

    def cancel(self, rid: int) -> bool:
        """Abort ONE request without publishing a result (the hedged
        dispatch's loser).  Device-staged rows cannot be plucked
        mid-stage.  Returns whether the request was found."""
        sched = self.scheduler
        for seq in list(sched.running):
            if seq.req.id == rid:
                sched.finish(seq)
                return True
        for seq in list(sched.pending):
            if seq.req.id == rid:
                sched.pending.remove(seq)
                sched._book()
                return True
        return False

    def _handoff(self, seq: Sequence) -> None:
        """Park a prefill-complete request for the fleet's tier boundary
        (``role="prefill"``): it exports (stream + ``kvsnap/1`` chain)
        BEFORE it leaves the scheduler, then ``finish`` parks its full
        chain on the prefix-cache LRU, still matchable here."""
        rid = seq.req.id
        rec = self.export_requests(rids=[rid]).get(rid)
        self.scheduler.finish(seq)
        if rec is not None:
            self.handoffs[rid] = rec

    # -- the scheduler loop --------------------------------------------------

    def step(self) -> bool:
        """One iteration: drain staging, admit (prefix-matching), draft
        (speculation on, decode-only batches), grow, then run ONE step —
        a MIXED step whenever prefill work is pending, a VERIFY step when
        any draft is pending, a decode step otherwise.  Returns False
        when there is nothing left."""
        idle = not self.scheduler.running and not self.scheduler.pending
        now = None
        if self.mesh is None:
            self._drain_staging(block=idle and not self._source_done)
        else:
            now = self._sync_intake(idle)
        if self._any_deadline:
            now = self._clock() if now is None else now
            self.scheduler.cancel_expired(now)
            self.scheduler.admit(now)
            self._finalize_shed()
        else:
            self.scheduler.admit()
        if self._drafter is not None and all(
                s.in_decode for s in self.scheduler.running):
            # drafts propose BEFORE growth (grow_running books the
            # speculative tail, shedding the draft under pool pressure),
            # and only for pure-decode batches: the chunk width of a
            # mixed step is the prefill tier axis
            for s in self.scheduler.running:
                self._propose_draft(s)
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
            if self.role == "prefill":
                # the handoff boundary: a request that just crossed into
                # decode leaves now (finished rows already published)
                for s, _c in sel:
                    if s.in_decode and not s.done:
                        self._handoff(s)
            return True
        if decode_rows:
            if any(s.draft for s in decode_rows):
                out, now = self._run_spec_step(decode_rows)
                # settle (accept + roll back) BEFORE publication: the
                # published count follows tokens_in_cache, which can
                # never reach into the truncated tail
                emitted = [self._settle_spec(s, out[i], now) if s.draft
                           else [int(out[i, 0])]
                           for i, s in enumerate(decode_rows)]
                for s in decode_rows:
                    self.scheduler.publish_full_blocks(s)
                for s, toks in zip(decode_rows, emitted):
                    for t in toks:
                        if s.done:  # eos/budget inside an accepted run
                            break
                        self._emit(s, t, now)
                return True
            toks, now = self._decode_once(decode_rows)
            for s in decode_rows:
                self.scheduler.publish_full_blocks(s)
            for i, s in enumerate(decode_rows):
                self._emit(s, toks[i], now)
            return True
        return not self._source_done or bool(self.scheduler.pending)

    def _sync_intake(self, idle: bool) -> float:
        """A sharded step's first act, on every rank of the set: the
        first rank drains its staging and broadcasts one header — the
        requests it took in since the last step, whether its source is
        done, its next request id and its clock — and every rank then
        submits those requests, in that order.  Returns the first
        rank's clock (the step's deadline time)."""
        group, src = self.mesh.group, self.mesh.ranks[0]
        if self.lead:
            self._drain_staging(block=idle and not self._source_done)
            header = [float(len(self._inbox)), float(self._source_done),
                      float(self._next_id), self._clock()]
        else:
            header = [0.0] * 4
        head = torch.tensor(header, dtype=torch.float64, device=self.device)
        # contract-ok: collectives -- every rank of the set opens each sharded step here (the JAX engine is one process, with no intake to share)
        dist.broadcast(head, src, group=group)
        n, done, next_id, now = head.tolist()
        reqs = [self._inbox] if self.lead else [None]
        if n:  # n is the broadcast header's, the same on every rank
            # contract-ok: collectives -- every rank of the set takes this branch together, on the header it just received
            dist.broadcast_object_list(reqs, src, group=group,
                                       device=self.device)
        self._inbox = []
        self._source_done = bool(done)
        self._next_id = int(next_id)
        for req in reqs[0] or ():  # ids checked where they entered
            self._ids_seen.add(req.id)
            if req.deadline_s:
                self._any_deadline = True
            self.scheduler.submit(Sequence(req=req, context=req.prompt))
        return now

    def run(self) -> Dict[int, np.ndarray]:
        """Drive :meth:`step` until every submitted/staged request has
        completed; returns ``results`` (id -> generated token ids)."""
        while self.step():
            pass
        return self.results

    # -- the static-batching baseline ----------------------------------------

    def run_static(self, requests: List[Request],
                   batch_size: int) -> Dict[int, np.ndarray]:
        """Static (request-level) batching baseline: fixed batches held
        until every member finishes, each member holding a reservation
        for the batch's worst-case length, no prefix caching and no
        token-budget pacing.  Runs the same step functions as the engine
        loop (``_run_mixed`` / ``_decode_once``), so an A/B isolates the
        scheduling policy."""
        results: Dict[int, np.ndarray] = {}
        for r in requests:
            self._validate_request(len(r.prompt), r.max_new_tokens,
                                   rid=r.id)
        for at in range(0, len(requests), batch_size):
            chunk = requests[at:at + batch_size]
            seqs = [Sequence(req=r, context=np.asarray(r.prompt, np.int32))
                    for r in chunk]
            worst = max(len(r.prompt) + r.max_new_tokens for r in chunk)
            for s in seqs:
                got = self.allocator.alloc(
                    blocks_for(worst, self.serve_cfg.block_size))
                if got is None:
                    raise RuntimeError(
                        "static baseline could not reserve "
                        f"{worst}-token contiguous KV for a batch of "
                        f"{len(chunk)} — the reservation waste paging "
                        "removes")
                s.blocks = got
            while True:
                todo = [s for s in seqs if not s.in_decode]
                if not todo:
                    break
                cap = self.serve_cfg.prefill_chunk or max(self.chunk_tiers)
                sel = [(s, min(len(s.context) - s.prefilled, cap))
                       for s in todo]
                toks, now = self._run_mixed([], sel)
                for j, (s, c) in enumerate(sel):
                    s.prefilled += c
                    if s.in_decode:
                        self._static_emit(s, toks[j, c - 1], now, results)
            while not all(s.done for s in seqs):
                toks, now = self._decode_once(seqs)
                for i, s in enumerate(seqs):
                    if not s.done:
                        self._static_emit(s, toks[i], now, results)
            for s in seqs:
                self.allocator.free(s.blocks)
                s.blocks = []
        return results

    def _static_emit(self, seq: Sequence, token: int, now: float,
                     results: Dict[int, np.ndarray]) -> None:
        self._observe_token(seq, token, now)
        if seq.done:
            results[seq.req.id] = np.asarray(seq.generated, np.int32)
