"""horovod_tpu_torch.guard — step-level integrity defense against silent
data corruption (SDC).

Port of ``horovod_tpu/guard.py``.  Every other robustness layer defends
against processes that *die* (exec-restart, chaos kills, preemption
drains); this one defends against processes that *lie*: a card computing
wrong gradients ("Cores that don't count", Hochschild et al.), a rank
whose parameters silently desync, a checkpoint that unpickles but is
garbage.  The transport MACs cannot see corruption that happens *inside*
the math — by the time a wrong value is on the wire it is correctly
signed.

The closed loop: **detect → attribute → quarantine → roll back →
converge**, automatically:

* **Cheap always-on detectors** — a NaN/Inf sentinel over loss+grads
  and a per-step gradient digest, both computed ON THE DEVICE by the
  training step (:func:`step_diag`: elementwise folds and reductions,
  zero collectives, no host sync); plus a host-side EMA loss-spike
  detector.  ONE bounded host sync per ``HVD_TPU_GUARD_CADENCE`` steps
  pulls the window.
* **Cross-rank agreement** — post-allreduce gradients (or ZeRO's
  post-allgather update deltas) and a param fingerprint must be
  BIT-identical across data-parallel ranks.  At cadence each rank
  publishes its window of per-step digests (a few bytes) through an
  exchange (the framework's ``allgather_object``, or a shared-directory
  board) and compares.
* **Attribution** — on disagreement, the FIRST divergent step of the
  window; with >2 ranks the majority digest names the minority; on a
  pairwise tie each rank RECOMPUTES the divergent step (a caller's
  ``recompute`` hook) and a second exchange round shares the verdicts.
* **Response** — the attributed rank reports ``failing`` (integrity
  flag) to the elastic driver, which QUARANTINES its whole host, and
  exits :data:`QUARANTINE_EXIT`.  Survivors roll back: checkpoints newer
  than the last *verified* step are discarded, the live state is dropped
  (an exec-restart with NO snapshot) and post-boot auto-resume restores
  the newest surviving checkpoint.  Outside the elastic driver the
  rollback raises :class:`IntegrityError` and the caller reloads.

The digest is the JAX package's, bit for bit: the same two mod-2^32
lanes over the same words in the same leaf order (``host_digest`` here
equals ``horovod_tpu.guard.host_digest`` on the same arrays), so the
packages share one digest space and one exchange board.  Every knob is
the JAX package's ``HVD_TPU_GUARD_*`` variable.

Exactness contract: the guarded step is BIT-identical to the unguarded
step when no fault fires — the digest and sentinel only read the
gradients — and adds no collective (``training.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import threading
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .common.retry import env_float, env_int
from .metrics import instruments as _metrics
from .utils.logging import get_logger

__all__ = [
    "IntegrityError", "IntegrityGuard", "Verdict", "CollectiveExchange",
    "FileBoardExchange", "device_allfinite", "device_digest", "grad_diag",
    "host_digest", "step_diag",
]

ENV_GUARD = "HVD_TPU_GUARD"
ENV_CADENCE = "HVD_TPU_GUARD_CADENCE"
ENV_SPIKE = "HVD_TPU_GUARD_SPIKE"
ENV_EMA = "HVD_TPU_GUARD_EMA"
ENV_BOARD = "HVD_TPU_GUARD_BOARD"
ENV_TIMEOUT = "HVD_TPU_GUARD_EXCHANGE_TIMEOUT"
#: wall-clock rollback start, carried ACROSS the exec-restart boundary
#: so recovery_seconds{phase="rollback"} spans detection to post-boot
#: resume
ENV_ROLLBACK_T0 = "HVD_TPU_GUARD_ROLLBACK_T0"
#: board generation, bumped by every rollback and carried across the
#: exec-restart: the post-rollback re-run REVISITS the poisoned window's
#: steps, and a pre-rollback board file for the same step must read as
#: absent (still being re-posted), never as fresh
ENV_GEN = "HVD_TPU_GUARD_GEN"
#: rollback-loop fuse, carried across the exec-restart: consecutive
#: rollbacks that never get PAST the step that tripped them mean the
#: fault reproduces deterministically — a real training divergence, not
#: transient corruption.  The count resets once a verified check passes
#: the recorded trip step.
ENV_ROLLBACK_COUNT = "HVD_TPU_GUARD_ROLLBACK_COUNT"
ENV_ROLLBACK_STEP = "HVD_TPU_GUARD_ROLLBACK_STEP"
ENV_MAX_ROLLBACKS = "HVD_TPU_GUARD_MAX_ROLLBACKS"
#: newest verified step, carried across the exec-restart: a SECOND trip
#: after a rollback restart must discard only past the same watermark
ENV_VERIFIED = "HVD_TPU_GUARD_VERIFIED_STEP"

#: exit code of a self-attributed (quarantining) rank — distinct from
#: generic failures in the driver's logs
QUARANTINE_EXIT = 86

_MIX = 0x9E3779B1  # odd golden-ratio constant (second digest lane)
_MASK = 0xFFFFFFFF


class IntegrityError(RuntimeError):
    """Raised by :meth:`IntegrityGuard.respond` in non-elastic contexts
    when corruption is detected: the caller owns recovery (reload a
    verified checkpoint).  Elastic workers never see it — the guard
    exec-restarts them through the rollback path instead."""


# -- digests -----------------------------------------------------------------
#
# A pair of mod-2^32 multiply-accumulate lanes over the bit patterns of
# every leaf ("u64 digest": 2 x uint32).  Lane 0 weights word i of leaf
# k by the ODD multiplier (2*i + 2*k + 1), so a single flipped bit b
# changes it by ±2^b * odd ≠ 0 (mod 2^32) — any single-bit flip is
# provably detected; lane 1 re-weights by the odd golden-ratio mix.
#
# Words: 1- and 2-byte leaves widen their unsigned bits, bools are 0/1,
# 4-byte leaves are their bits, and 8-byte leaves are first cast to
# their 32-bit counterparts (int64 → int32, float64 → float32) — the JAX
# package's rule under its default x64-off config, fixed here on both
# the host and the device side.  Leaves come in ``jax.tree_util``'s
# order: dict keys sorted, lists and tuples in order, ``None`` no leaf.


def _leaves(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, torch.nn.Module):
        return [p.detach() for p in tree.parameters()]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _np_bits(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array of the same bits (bf16 and friends
    as unsigned words of their width)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bool:
        return t.numpy()
    if t.dtype.is_complex:
        raise TypeError("complex leaves have no digest words")
    if t.element_size() == 8:
        t = t.to(torch.float32 if t.dtype.is_floating_point
                 else torch.int32)
    size = t.element_size()
    if size == 1:
        return t.view(torch.uint8).numpy()
    if size == 2:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.view(torch.int32).numpy().view(np.uint32)


def _host_words(a) -> np.ndarray:
    """A leaf's words as a flat uint32 vector (host)."""
    if isinstance(a, torch.Tensor):
        a = _np_bits(a)
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype == np.bool_:
        return a.astype(np.uint32).ravel()
    if a.dtype.itemsize == 8:
        kind = a.dtype.kind
        a = np.ascontiguousarray(a.astype(
            {"f": np.float32, "i": np.int32, "u": np.uint32}.get(
                kind, np.float32)))
    if a.dtype.itemsize == 1:
        return a.view(np.uint8).astype(np.uint32).ravel()
    if a.dtype.itemsize == 2:
        return a.view(np.uint16).astype(np.uint32).ravel()
    return a.view(np.uint32).ravel()


def host_digest(tree) -> np.ndarray:
    """The (2,) uint32 digest computed on the host (numpy): equal to
    :func:`device_digest` for identical contents, and to the JAX
    package's ``host_digest``.  Leaves may be numpy arrays (``ml_dtypes``
    bfloat16 included) or tensors (pulled to the host)."""
    lane0 = np.uint64(0)
    lane1 = np.uint64(0)
    mask = np.uint64(_MASK)
    for k, leaf in enumerate(_leaves(tree)):
        w = _host_words(leaf).astype(np.uint64)
        idx = np.arange(w.size, dtype=np.uint64)
        m = (idx * np.uint64(2) + np.uint64(2 * k + 1)) & mask
        # products wrap mod 2^64; 2^32 | 2^64 so the final mod-2^32
        # fold equals the per-element uint32 wraparound
        with np.errstate(over="ignore"):
            lane0 = (lane0 + np.sum(w * m, dtype=np.uint64)) & mask
            lane1 = (lane1 + np.sum(w * ((m * np.uint64(_MIX)) & mask),
                                    dtype=np.uint64)) & mask
    return np.array([lane0, lane1], np.uint32)


#: columns of the device fold's (rows, columns) view of a packed buffer,
#: and the rows one int64 chunk of the fold covers (a 256 MiB temporary)
_COLS = 1024
_CHUNK_ROWS = (1 << 25) // _COLS


def _word_view(dtype: torch.dtype):
    """``(integer dtype to view a buffer of dtype as, mask)``: the view's
    values, widened to int64 and masked, are congruent to the words
    mod 2^32 (a 4-byte word's signed value is congruent to its unsigned
    one; 2-byte words need their sign bits masked off; 8-byte integer
    leaves keep their low word, as the cast to 32 bits does)."""
    if dtype == torch.bool:
        return torch.uint8, None
    size = torch.empty((), dtype=dtype).element_size()
    return {1: (torch.uint8, None), 2: (torch.int16, 0xFFFF),
            4: (torch.int32, None), 8: (torch.int64, _MASK)}[size]


class _Packing:
    """One dtype's leaves packed into a zero-padded flat buffer, each
    leaf starting on a row of :data:`_COLS` words (pads read as 0).
    Made once per layout (:func:`_packing`) and refilled each call with
    one multi-tensor copy, so a step's fold is a fixed, small number of
    kernel launches whatever the leaf count.

    Lane 0 of leaf i (index k_i, at word offset o_i) is ``Σ_j w_j
    (2j + 2k_i + 1) = 2·Σ_t t·w_t + (2k_i + 1 − 2o_i)·Σ_j w_j`` with t
    the word's index in the buffer; ``Σ_t t·w_t`` splits ``t = r·C + c``
    into ``C·Σ_r r·rowsum_r + Σ_c c·colsum_c``, and each leaf's sum is
    the sum of its rows.  Every int64 intermediate stays below 2^63
    (each factor is reduced mod 2^32 first, the per-leaf product is
    split in 16-bit halves), so the fold is exact."""

    def __init__(self, dtype, device, ks, shapes):
        numels = [int(np.prod(sh, dtype=np.int64)) for sh in shapes]
        rows = [-(-n // _COLS) for n in numels]
        offsets = np.concatenate([[0], np.cumsum(rows)[:-1]]) * _COLS
        self.rows = int(sum(rows))
        self.buf = torch.zeros(self.rows * _COLS, dtype=dtype, device=device)
        self.views = [self.buf[o:o + n].view(sh)
                      for o, n, sh in zip(offsets.tolist(), numels, shapes)]
        self.word, self.mask = _word_view(dtype)
        coef = (2 * np.asarray(ks, np.int64) + 1 - 2 * offsets) & _MASK
        self.coef_lo = torch.tensor(coef & 0xFFFF, device=device)
        self.coef_hi = torch.tensor(coef >> 16, device=device)
        self.row_leaf = torch.tensor(
            np.repeat(np.arange(len(rows)), rows), device=device)
        self.row_idx = torch.arange(self.rows, device=device)
        self.col_idx = torch.arange(_COLS, device=device)
        self.floating = dtype.is_floating_point

    def fill(self, leaves) -> None:
        torch._foreach_copy_(self.views, leaves)

    def lane0(self) -> torch.Tensor:
        words = self.buf.view(self.word).view(self.rows, _COLS)
        rowsum = torch.empty(self.rows, dtype=torch.int64,
                             device=self.buf.device)
        colsum = torch.zeros(_COLS, dtype=torch.int64,
                             device=self.buf.device)
        for r0 in range(0, self.rows, _CHUNK_ROWS):
            r1 = min(self.rows, r0 + _CHUNK_ROWS)
            blk = words[r0:r1].to(torch.int64)
            if self.mask is not None:
                blk &= self.mask
            torch.sum(blk, 1, out=rowsum[r0:r1])
            colsum += blk.sum(0)
            del blk
        weighted = (((((rowsum & _MASK) * self.row_idx) & _MASK).sum()
                     & _MASK) * _COLS
                    + ((colsum & _MASK) * self.col_idx).sum())
        per_leaf = torch.zeros(self.coef_lo.shape[0], dtype=torch.int64,
                               device=self.buf.device)
        per_leaf.index_add_(0, self.row_leaf, rowsum)
        per_leaf &= _MASK
        terms = (per_leaf * self.coef_lo
                 + (((per_leaf * self.coef_hi) & 0xFFFF) << 16))
        return (2 * (weighted & _MASK) + terms.sum()) & _MASK

    def finite(self) -> torch.Tensor:
        # the max-norm: NaN propagates through the max, which never
        # overflows (the pads are zeros)
        return torch.linalg.vector_norm(self.buf, float("inf")).isfinite()


@functools.lru_cache(maxsize=8)
def _packing(dtype, device, ks: tuple, shapes: tuple) -> _Packing:
    """The packing of one layout, made once: the buffer and its index
    tensors then stay on the device (a fresh host list copied to the
    card each call would synchronise the host with the device and stall
    the step's dispatch).  One stream at a time may use a packing."""
    return _Packing(dtype, device, ks, shapes)


def _pack(tree, floating_only: bool = False) -> List[_Packing]:
    """``tree``'s non-empty leaves packed by dtype and device (float64
    leaves as their float32 casts, the 64-bit rule), filled."""
    groups: Dict[tuple, List[tuple]] = defaultdict(list)
    for k, leaf in enumerate(_leaves(tree)):
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.as_tensor(np.asarray(leaf))
        if leaf.dtype.is_complex:
            raise TypeError("complex leaves have no digest words")
        if leaf.dtype == torch.float64:
            leaf = leaf.to(torch.float32)
        if leaf.numel() and (leaf.is_floating_point() or not floating_only):
            groups[(leaf.dtype, leaf.device)].append((k, leaf))
    packs = []
    for (dtype, dev), members in groups.items():
        pk = _packing(dtype, dev, tuple(k for k, _ in members),
                      tuple(tuple(x.shape) for _, x in members))
        with torch.no_grad():
            pk.fill([x for _, x in members])
        packs.append(pk)
    return packs


def _digest_of(packs: Sequence[_Packing]) -> torch.Tensor:
    """The (2,) digest from packed leaves.  Lane 1 is lane 0 times the
    mix constant: ``Σ w·(m·MIX)`` and ``MIX·Σ w·m`` are one number mod
    2^32."""
    lane0 = None
    for pk in packs:
        part = pk.lane0()
        lane0 = part if lane0 is None else (
            (lane0.to(part.device) + part) & _MASK)
    if lane0 is None:
        return torch.zeros(2, dtype=torch.int64)
    lane1 = (lane0 * (_MIX & 0xFFFF)
             + (((lane0 * (_MIX >> 16)) & 0xFFFF) << 16)) & _MASK
    return torch.stack([lane0, lane1])


def _finite_of(packs: Sequence[_Packing]) -> torch.Tensor:
    ok = None
    for pk in packs:
        if pk.floating:
            this = pk.finite()
            ok = this if ok is None else ok.to(this.device) & this
    return torch.tensor(True) if ok is None else ok


def device_digest(tree) -> torch.Tensor:
    """(2,) digest of every leaf's bit pattern, computed where the
    tensors live (a copy into a packed buffer, elementwise ops and
    reductions: NO collective and no host sync — safe to add to any
    step without changing its dataflow).  An int64 tensor holding the
    two uint32 lanes; equal to :func:`host_digest` (:class:`_Packing`
    has the arithmetic)."""
    return _digest_of(_pack(tree))


def device_allfinite(tree) -> torch.Tensor:
    """0-d bool tensor: every floating leaf is NaN/Inf-free (integer
    leaves pass)."""
    return _finite_of(_pack(tree, floating_only=True))


def grad_diag(grads):
    """``(digest, finite)`` of a gradient set from ONE packing: what a
    guarded step adds between its gradient reduction and its optimizer
    update."""
    packs = _pack(grads)
    return _digest_of(packs), _finite_of(packs)


def step_diag(loss, grads) -> Dict[str, Any]:
    """The guarded step's extra outputs: the always-on detectors,
    evaluated on the device.  ``digest`` is over the POST-reduction
    gradients (what must be bit-identical across data-parallel ranks);
    ``finite`` covers loss and gradients.

    SCOPE: agreement on post-reduction values catches corruption in the
    exchange, the wire, the optimizer update and state desync.  A wrong
    LOCAL gradient folded into the allreduce is corrupted IDENTICALLY on
    every rank; catching that class needs a redundant recompute of the
    sampled microbatch (the host-loop ``tap_grads`` path and the
    attribution ``recompute`` hook)."""
    digest, finite = grad_diag(grads)
    return {"finite": finite & torch.isfinite(torch.as_tensor(loss)).all(),
            "digest": digest}


def _canon(digest) -> bytes:
    """Any digest form (tensor, numpy, bytes, hex str) to the canonical
    8-byte wire form (the JAX package's)."""
    if isinstance(digest, bytes):
        return digest
    if isinstance(digest, str):
        return bytes.fromhex(digest)
    if isinstance(digest, torch.Tensor):
        digest = digest.detach().cpu().numpy()
    return np.asarray(digest).astype(np.uint32).tobytes()


def _pull(values: Sequence[Any]) -> List[Any]:
    """The window's digests on the host: the device tensors of each
    device come down in ONE stacked copy (one sync), not one per step."""
    out = list(values)
    by_dev: Dict[torch.device, List[int]] = defaultdict(list)
    for i, v in enumerate(out):
        if isinstance(v, torch.Tensor):
            by_dev[v.device].append(i)
    for idxs in by_dev.values():
        host = torch.stack([out[i].to(torch.int64) for i in idxs]).cpu()
        for i, row in zip(idxs, host.numpy()):
            out[i] = row
    return out


# -- exchanges ---------------------------------------------------------------


class FileBoardExchange:
    """Digest exchange over a shared directory ("board"): each rank
    publishes ``<key>.rank<R>`` atomically (tmp + rename) and polls for
    its peers under a timeout.  The exchange for processes that share a
    filesystem but not a process group; the format is the JAX package's,
    so ranks of either package can share one board.

    Entries carry a GENERATION header (``HVD_TPU_GUARD_GEN``, bumped by
    every rollback and inherited across the exec-restart): the
    post-rollback re-run revisits the poisoned window's step numbers,
    and a pre-rollback entry for the same key must read as *absent*,
    never as fresh.  Entries are never deleted mid-job (deleting raced
    slower peers out of entries they were mid-gather on); the board
    directory is per-job temp space."""

    def __init__(self, directory: str, *, timeout: float = 30.0,
                 poll: float = 0.02, generation: Optional[int] = None):
        self.directory = directory
        self.timeout = timeout
        self.poll = poll
        self.generation = (env_int(ENV_GEN, 0)
                           if generation is None else int(generation))
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str, rank: int) -> str:
        return os.path.join(self.directory, f"{key}.rank{rank}")

    def gather(self, key: str, payload: bytes, *, world: int,
               rank: int) -> List[Optional[bytes]]:
        gen = b"%08x\n" % self.generation
        tmp = self._path(key, rank) + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(gen + payload)
        os.replace(tmp, self._path(key, rank))  # atomic publish
        out: List[Optional[bytes]] = [None] * world
        out[rank] = payload
        deadline = time.monotonic() + self.timeout
        missing = [r for r in range(world) if r != rank]
        while missing and time.monotonic() < deadline:
            for r in list(missing):
                try:
                    with open(self._path(key, r), "rb") as f:
                        blob = f.read()
                except FileNotFoundError:
                    continue
                try:
                    file_gen = int(blob[:8], 16)
                except ValueError:
                    continue  # torn write: re-poll
                if file_gen < self.generation:
                    continue  # pre-rollback entry: peer will overwrite
                out[r] = blob[9:]
                missing.remove(r)
            if missing:
                time.sleep(self.poll)
        return out


class CollectiveExchange:
    """Digest exchange over the framework's own
    :func:`~horovod_tpu_torch.functions.allgather_object` — a few bytes
    over the process group, the default for multi-process worlds."""

    def gather(self, key: str, payload: bytes, *, world: int,
               rank: int) -> List[Optional[bytes]]:
        from . import functions

        del key  # the collective itself sequences the rounds
        out = functions.allgather_object(payload)
        if len(out) != world:
            return out + [None] * (world - len(out))
        return out


# -- verdicts ----------------------------------------------------------------


@dataclasses.dataclass
class Verdict:
    """Outcome of one cadence check."""

    step: int
    ok: bool
    kind: str  # verified | partial | nan | mismatch
    #: ranks named as corrupt (majority vote or recompute self-report)
    attributed: List[int] = dataclasses.field(default_factory=list)
    #: True when THIS rank is in ``attributed`` (quarantine path)
    self_attributed: bool = False
    #: first step in the window whose gradient digests diverged (None:
    #: the divergence predates the window — param-only drift)
    divergent_step: Optional[int] = None
    #: advisory loss-spike flag (EMA detector; never fails the verdict
    #: by itself — spikes have benign causes, digests do not)
    spike: bool = False
    detail: str = ""


class IntegrityGuard:
    """The closed loop's driver (module docstring).  One instance per
    training process; host-side — training steps feed it device
    diagnostics (:func:`step_diag`), host loops feed it
    :func:`host_digest` values through :meth:`tap_grads` /
    :meth:`observe_grads`."""

    def __init__(self, *, enabled: bool = True, cadence: int = 16,
                 spike: float = 10.0, ema_alpha: float = 0.9,
                 world: int = 1, rank: int = 0, exchange=None,
                 ckpt_dir: Optional[str] = None,
                 exit_fn: Callable[[int], None] = os._exit):
        if cadence < 1:
            raise ValueError(f"cadence must be >= 1, got {cadence}")
        self.enabled = bool(enabled)
        self.cadence = int(cadence)
        self.spike = float(spike)
        self.ema_alpha = float(ema_alpha)
        self.world = int(world)
        self.rank = int(rank)
        self.exchange = exchange
        self.ckpt_dir = ckpt_dir
        self._exit = exit_fn
        # inherited across a rollback exec-restart: the re-run's
        # watermark starts where the verified ring ends, never at 0
        self.last_verified_step = env_int(ENV_VERIFIED, 0)
        self.last_rollback_s: Optional[float] = None
        #: rollback-loop fuse state: trips of the SAME step accumulate
        #: until a verified check passes it
        self.max_rollbacks = max(1, env_int(ENV_MAX_ROLLBACKS, 3))
        self._rollback_count = env_int(ENV_ROLLBACK_COUNT, 0)
        self._rollback_barrier = env_int(ENV_ROLLBACK_STEP, -1)
        self._ema: Optional[float] = None
        self._ema_n = 0
        self._window: List[tuple] = []  # (step, digest as given)
        self._lock = threading.Lock()
        t0 = os.environ.pop(ENV_ROLLBACK_T0, None)
        if t0 is not None:
            try:
                self.last_rollback_s = max(0.0, time.time() - float(t0))
                _metrics.RECOVERY_SECONDS.labels("rollback").set(
                    self.last_rollback_s)
                get_logger().info(
                    "guard: rollback completed in %.2fs (detection -> "
                    "post-boot resume)", self.last_rollback_s)
            except ValueError:
                pass

    @classmethod
    def from_env(cls, *, world: Optional[int] = None,
                 rank: Optional[int] = None,
                 ckpt_dir: Optional[str] = None,
                 exchange=None, **overrides) -> "IntegrityGuard":
        """Build from the ``HVD_TPU_GUARD_*`` knobs.
        ``HVD_TPU_GUARD_BOARD`` selects the shared-directory exchange;
        otherwise multi-process worlds default to the framework's
        allgather (:class:`CollectiveExchange`).  The world is the
        processes (one per GPU)."""
        if world is None or rank is None:
            from .common import basics

            if basics.is_initialized():
                world = basics.size() if world is None else world
                rank = basics.rank() if rank is None else rank
            else:
                world = 1 if world is None else world
                rank = 0 if rank is None else rank
        if exchange is None and world > 1:
            board = os.environ.get(ENV_BOARD)
            timeout = env_float(ENV_TIMEOUT, 30.0)
            if board:
                exchange = FileBoardExchange(board, timeout=timeout)
            else:
                exchange = CollectiveExchange()
        kw = dict(
            enabled=bool(env_int(ENV_GUARD, 0)),
            cadence=env_int(ENV_CADENCE, 16),
            spike=env_float(ENV_SPIKE, 10.0),
            ema_alpha=env_float(ENV_EMA, 0.9),
        )
        kw.update(overrides)
        return cls(world=world, rank=rank, exchange=exchange,
                   ckpt_dir=ckpt_dir, **kw)

    # -- per-step feeds ------------------------------------------------------

    def due(self, step: int) -> bool:
        """True on cadence steps (and never on step 0)."""
        return self.enabled and step > 0 and step % self.cadence == 0

    def tap_grads(self, array):
        """Host-loop gradient tap: the ``guard.grad`` chaos site — a
        ``flipbit`` rule here IS the silent-corruption drill (the
        returned, possibly-corrupted array is what the trainer applies,
        exactly as a lying card would hand it over)."""
        from . import chaos as _chaos

        if _chaos.active:
            return _chaos.point("guard.grad", array)
        return array

    def tap_params(self, array):
        """Host-loop param-fingerprint tap (``guard.param`` site)."""
        from . import chaos as _chaos

        if _chaos.active:
            return _chaos.point("guard.param", array)
        return array

    def observe_grads(self, step: int, digest) -> None:
        """Append one step's gradient digest to the agreement window.
        ``digest`` may be a live device tensor — it is NOT synced here
        (the cadence check syncs the whole window in one pass)."""
        if not self.enabled:
            return
        with self._lock:
            self._window.append((int(step), digest))
            # bound the window: everything older than one cadence has
            # either been verified or already rolled back
            if len(self._window) > 2 * self.cadence:
                del self._window[:-2 * self.cadence]

    def param_digest(self, params) -> torch.Tensor:
        """The param fingerprint: :func:`device_digest` over a module's
        parameters (or any tree of tensors)."""
        return device_digest(params)

    # -- the cadence check ---------------------------------------------------

    def _spike_check(self, step: int, loss: float) -> bool:
        if not np.isfinite(loss) or self.spike <= 0:
            return False
        tripped = False
        if self._ema is not None and self._ema_n >= 3:
            floor = max(abs(self._ema), 1e-8)
            if abs(loss) > self.spike * floor:
                tripped = True
                _metrics.GUARD_TRIPS.labels("spike").inc()
                get_logger().warning(
                    "guard: loss spike at step %d — |%.4g| > %.1fx EMA "
                    "%.4g (advisory; digests decide corruption)",
                    step, loss, self.spike, self._ema)
        a = self.ema_alpha
        self._ema = loss if self._ema is None else a * self._ema + (
            1 - a) * loss
        self._ema_n += 1
        return tripped

    def check(self, step: int, *, loss: Optional[float] = None,
              finite: bool = True, param_digest=None,
              recompute: Optional[Callable[[int], Any]] = None
              ) -> Verdict:
        """Run the cadence check: detectors, then cross-rank agreement
        over the window gathered since the previous check.

        ``recompute(divergent_step)`` re-derives that step's gradient
        digest (the redundant-recompute vote on the sampled
        microbatch): deterministic trainers pass an exact recompute; a
        data-parallel trainer can reproduce only the current step's
        retained microbatch and passes None otherwise — mismatches then
        resolve by majority, or stay unattributed (rollback-only)."""
        step = int(step)
        _metrics.GUARD_CHECKS.labels("finite").inc()
        spike = False
        if loss is not None:
            _metrics.GUARD_CHECKS.labels("spike").inc()
            spike = self._spike_check(step, float(loss))
        nan = (not finite
               or (loss is not None and not np.isfinite(loss)))
        if nan:
            _metrics.GUARD_TRIPS.labels("finite").inc()
            get_logger().error(
                "guard: NaN/Inf detected at step %d — rolling back to "
                "the last verified checkpoint", step)

        with self._lock:
            entries = list(self._window)
            self._window.clear()
        # THE one bounded host sync per cadence: the window's device
        # digests come down together
        vals = _pull([d for _, d in entries])
        window = [(s, _canon(v).hex())
                  for (s, _), v in zip(entries, vals)]
        if self.world <= 1 or self.exchange is None:
            if nan:
                return Verdict(step=step, ok=False, kind="nan",
                               spike=spike,
                               detail="non-finite loss/gradients")
            self._mark_verified(step)
            return Verdict(step=step, ok=True, kind="verified",
                           spike=spike)

        # a NaN-tripped rank must STILL join the exchange: peers are
        # already entering this step's gather, and a rank that bails
        # early leaves them blocked in a collective that never
        # completes (or stalling a full board timeout) — the nan flag
        # rides the payload instead, so every rank reaches the same
        # verdict in the same number of rounds
        _metrics.GUARD_CHECKS.labels("digest").inc()
        payload = json.dumps({
            "step": step,
            "window": window,
            "nan": nan,
            "param": None if param_digest is None
            else _canon(param_digest).hex(),
        }).encode()
        from . import trace

        with trace.span("guard.exchange", step=step, round="digest"):
            boards = self.exchange.gather(f"chk-{step}", payload,
                                          world=self.world, rank=self.rank)
        views: List[Optional[dict]] = []
        for b in boards:
            try:
                views.append(None if b is None else json.loads(b))
            except ValueError:
                views.append(None)
        if any(v is None for v in views):
            missing = [r for r, v in enumerate(views) if v is None]
            get_logger().warning(
                "guard: step-%d agreement check missing rank(s) %s "
                "(exchange timeout) — window unverified", step, missing)
            if nan:
                return Verdict(step=step, ok=False, kind="nan",
                               spike=spike,
                               detail="non-finite loss/gradients")
            return Verdict(step=step, ok=True, kind="partial",
                           spike=spike,
                           detail=f"missing ranks {missing}")
        nan_ranks = [r for r, v in enumerate(views) if v.get("nan")]
        if nan_ranks:
            # non-finite values anywhere poison the window for every
            # rank (the allreduce already mixed them in): rollback-all,
            # no attribution — a NaN names a value, not its producer
            return Verdict(step=step, ok=False, kind="nan", spike=spike,
                           detail=f"non-finite on rank(s) {nan_ranks}")
        verdict = self._judge(step, views, recompute)
        verdict.spike = spike
        if verdict.ok:
            self._mark_verified(step)
        return verdict

    def _mark_verified(self, step: int) -> None:
        self.last_verified_step = step
        os.environ[ENV_VERIFIED] = str(step)  # survives the execv
        _metrics.GUARD_LAST_VERIFIED.set(step)
        if 0 <= self._rollback_barrier < step:
            # progress got PAST the step that tripped the last
            # rollback: the fault was transient — disarm the loop fuse
            self._rollback_count = 0
            self._rollback_barrier = -1
            os.environ.pop(ENV_ROLLBACK_COUNT, None)
            os.environ.pop(ENV_ROLLBACK_STEP, None)

    def _judge(self, step: int, views: Sequence[dict],
               recompute) -> Verdict:
        """Compare the gathered windows/param digests; attribute."""
        params = [v.get("param") for v in views]
        tables = [dict(v.get("window") or ()) for v in views]
        all_steps = sorted({s for t in tables for s in t})
        divergent = None
        for s in all_steps:
            vals = {t.get(s) for t in tables if s in t}
            if len(vals) > 1:
                divergent = s
                break
        # a rank that fingerprinted no params (the hook is optional)
        # abstains — absence must never read as disagreement
        params_agree = len({p for p in params if p is not None}) <= 1
        if divergent is None and params_agree:
            return Verdict(step=step, ok=True, kind="verified")

        _metrics.GUARD_TRIPS.labels("digest").inc()
        # -- attribute: majority vote at the first divergent point ----------
        if divergent is not None:
            votes = [t.get(divergent) for t in tables]
        else:
            votes = list(params)
        # a rank with NO entry at the divergent step (e.g. it restarted
        # mid-window) casts no vote: it neither supports nor contradicts
        # the majority, and must never be attributed by absence
        cast = [v for v in votes if v is not None]
        counts: Dict[Any, int] = {}
        for v in cast:
            counts[v] = counts.get(v, 0) + 1
        modal, modal_n = max(counts.items(), key=lambda kv: kv[1])
        attributed: List[int] = []
        if modal_n * 2 > len(cast):
            attributed = [r for r, v in enumerate(votes)
                          if v is not None and v != modal]
            outcome = ("self" if self.rank in attributed
                       else "peer" if attributed else "unattributed")
        else:
            # pairwise tie: the redundant-recompute vote — my own
            # recompute of the divergent step disagreeing with what I
            # published means the corruption was MINE; a second
            # exchange round shares verdicts
            self_ok = True
            if divergent is not None and recompute is not None:
                try:
                    mine = tables[self.rank].get(divergent)
                    redone = _canon(recompute(divergent)).hex()
                    self_ok = (mine is None) or (redone == mine)
                except Exception as e:  # a failing recompute is no vote
                    get_logger().warning(
                        "guard: recompute vote failed (%s: %s)",
                        type(e).__name__, e)
            from . import trace

            with trace.span("guard.exchange", step=step, round="vote"):
                flags = self.exchange.gather(
                    f"vote-{step}", b"1" if self_ok else b"0",
                    world=self.world, rank=self.rank)
            attributed = [r for r, f in enumerate(flags) if f == b"0"]
            outcome = ("self" if self.rank in attributed
                       else "peer" if attributed else "unattributed")
        _metrics.GUARD_ATTRIBUTIONS.labels(outcome).inc()
        get_logger().error(
            "guard: CROSS-RANK DIGEST MISMATCH at step %d (first "
            "divergent step %s) — attributed rank(s) %s%s",
            step, divergent, attributed or "none (unattributed)",
            " [THIS RANK]" if self.rank in attributed else "")
        return Verdict(
            step=step, ok=False, kind="mismatch", attributed=attributed,
            self_attributed=self.rank in attributed,
            divergent_step=divergent,
            detail=f"votes={votes}")

    # -- response policy -----------------------------------------------------

    def respond(self, verdict: Verdict, state=None) -> None:
        """Drive the response: nothing on ok; quarantine when THIS rank
        was attributed; roll back to the last verified checkpoint
        otherwise (non-elastic contexts raise :class:`IntegrityError`
        instead of exec-restarting)."""
        if verdict.ok:
            return
        if verdict.self_attributed:
            self.quarantine(verdict)
            return  # only reachable with a test exit_fn
        self.rollback(state=state, reason=verdict.kind,
                      step=verdict.step)

    def quarantine(self, verdict: Verdict) -> None:
        """This rank computed a wrong value: report the integrity
        failure to the elastic driver (which blacklists this whole
        HOST) and exit with :data:`QUARANTINE_EXIT`."""
        get_logger().error(
            "guard: this rank attributed as corrupt at step %d — "
            "reporting integrity failure and quarantining (exit %d)",
            verdict.step, QUARANTINE_EXIT)
        try:
            # flight recorder: the quarantined rank's final spans leave
            # with the bundle, not with the process image
            from .trace import flight as _flight

            _flight.maybe_dump("quarantine", extra={
                "step": verdict.step,
                "divergent_step": verdict.divergent_step})
        except Exception:
            pass
        try:
            from .elastic.worker import (
                elastic_enabled, notification_manager,
            )

            if elastic_enabled():
                notification_manager.report_integrity_failure(
                    f"silent corruption attributed at step "
                    f"{verdict.step} (divergent step "
                    f"{verdict.divergent_step})")
                time.sleep(0.2)  # let the report drain before exit
        except Exception:
            pass  # the exit itself still blacklists the slot
        self._exit(QUARANTINE_EXIT)

    def rollback(self, state=None, reason: str = "mismatch",
                 step: Optional[int] = None) -> None:
        """Survivor response: discard the poisoned window.  Checkpoints
        newer than the last VERIFIED step are deleted, the board
        generation is bumped (stale exchange entries read as absent),
        and in elastic mode the worker exec-restarts with NO live
        snapshot — post-boot auto-resume then restores the newest
        surviving (verified, checksummed) checkpoint and the skipped
        steps re-run.  Non-elastic callers get :class:`IntegrityError`
        and own their own reload.

        The checkpoint ring's ``keep`` must exceed the guard cadence
        (``fit_epoch`` defaults it to ``max(3, 2·cadence)`` with a guard
        armed): a shallower ring can have every entry inside the
        poisoned window, leaving nothing to roll back to.

        LOOP FUSE: ``HVD_TPU_GUARD_MAX_ROLLBACKS`` (default 3)
        consecutive rollbacks without a verified check ever getting
        PAST the tripping step mean the fault reproduces
        deterministically; the guard then refuses to restart and
        raises :class:`IntegrityError` naming the step."""
        del state  # the live state is poisoned by definition; never kept
        if step is not None:
            self._rollback_barrier = max(self._rollback_barrier,
                                         int(step))
        self._rollback_count += 1
        if self._rollback_count > self.max_rollbacks:
            get_logger().error(
                "guard: %d consecutive rollbacks never got past step "
                "%s — this failure REPRODUCES deterministically "
                "(likely a real training divergence, not transient "
                "corruption); refusing to restart again",
                self._rollback_count - 1, self._rollback_barrier)
            raise IntegrityError(
                f"integrity trip at step {self._rollback_barrier} "
                f"reproduced across {self._rollback_count - 1} "
                f"rollbacks ({reason}); refusing another restart — "
                "inspect the training run (HVD_TPU_GUARD_MAX_ROLLBACKS "
                "raises the fuse)")
        os.environ[ENV_ROLLBACK_COUNT] = str(self._rollback_count)
        os.environ[ENV_ROLLBACK_STEP] = str(self._rollback_barrier)
        _metrics.GUARD_ROLLBACKS.inc()
        get_logger().error(
            "guard: rolling back to last verified step %d (%s)",
            self.last_verified_step, reason)
        if self.ckpt_dir:
            from . import checkpoint as _checkpoint

            removed = _checkpoint.discard_newer_than(
                self.ckpt_dir, self.last_verified_step)
            if removed:
                get_logger().warning(
                    "guard: discarded %d checkpoint(s) inside the "
                    "poisoned window: %s", len(removed),
                    [os.path.basename(p) for p in removed])
        # bump the board generation (inherited across the execv): the
        # re-run's exchanges must never read this era's entries
        os.environ[ENV_GEN] = str(env_int(ENV_GEN, 0) + 1)
        os.environ[ENV_ROLLBACK_T0] = f"{time.time():.4f}"
        try:
            from .trace import flight as _flight

            _flight.maybe_dump("rollback", extra={
                "reason": reason,
                "verified_step": self.last_verified_step})
        except Exception:
            pass
        from .elastic.worker import _persist_and_exec, elastic_enabled

        if elastic_enabled():
            _persist_and_exec(None)  # does not return
        raise IntegrityError(
            f"silent corruption detected ({reason}); rolled the "
            f"checkpoint ring back to verified step "
            f"{self.last_verified_step} — reload it to continue")

    # -- training-step convenience -------------------------------------------

    def on_train_step(self, step: int, loss, diag: Dict[str, Any],
                      params=None,
                      recompute: Optional[Callable[[int], Any]] = None,
                      state=None) -> Optional[Verdict]:
        """One call per training step from a loop
        (:func:`training.fit_epoch` wires this): records the step's
        device digest without syncing, and at cadence performs the ONE
        bounded host sync (window + loss + param fingerprint), the
        agreement check, and the response.  Returns the verdict on
        cadence steps (None between them)."""
        if not self.enabled:
            return None
        self.observe_grads(step, diag["digest"])
        if not self.due(step):
            return None
        finite = bool(diag["finite"])
        pdig = self.param_digest(params) if params is not None else None
        verdict = self.check(
            step, loss=float(loss), finite=finite,
            param_digest=pdig, recompute=recompute)
        self.respond(verdict, state=state)
        return verdict
