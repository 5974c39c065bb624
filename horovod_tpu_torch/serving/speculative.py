"""Speculative decoding on the chunk machinery (drafters + acceptance).

Copied from ``horovod_tpu/serving/speculative.py`` (host-side, no device
code).  Decode re-streams the weights and the paged KV every step, so
speculative decoding (Leviathan et al. 2023) gets more tokens out of the
same bytes by VERIFYING k drafted tokens in one step: a verification row
is a chunk row of length k+1 at the sequence tail, scored by the same
per-row-offset attention kernel as a prefill chunk.  Greedy accept/reject
reproduces the non-speculative token stream exactly whatever the draft
quality — a bad drafter costs throughput, never correctness.

This module holds the :class:`Drafter` protocol, the zero-parameter
prompt-lookup drafter (Saxena 2023), the :class:`ModelDrafter` hook and
:func:`accept_greedy`; the engine packs verification rows into the mixed
step and rolls rejected tails back (``BlockAllocator.truncate_tail``).
"""

from __future__ import annotations

from typing import Callable, List, Protocol, Sequence, Tuple, runtime_checkable


@runtime_checkable
class Drafter(Protocol):
    """Anything that proposes up to ``k`` next tokens for a sequence.

    ``tokens`` is the sequence's full visible history (prompt +
    generated so far); the return is a list of AT MOST ``k`` proposed
    continuations (possibly empty — no draft means the engine falls
    back to a plain one-token decode step for that sequence).
    Drafts are proposals only: greedy verification makes acceptance
    exact, so a drafter may be arbitrarily wrong."""

    def draft(self, tokens: Sequence[int], k: int) -> List[int]:
        ...


class PromptLookupDrafter:
    """Zero-parameter n-gram drafter (prompt lookup, Saxena 2023).

    Finds an earlier occurrence of the sequence's trailing n-gram
    (longest first, ``max_ngram`` down to ``min_ngram``) in its own
    history and proposes the tokens that followed it.  Among matches of
    the winning n-gram the MOST RECENT one with a full ``k``-token
    continuation wins (recency tracks the current phrasing; but a match
    sitting right at the cursor can only contribute the couple of
    tokens between itself and the end — on short-period repetition that
    starves every draft, so a slightly older full-length match beats a
    newer truncated one).  Falls back to the most recent match when no
    occurrence has ``k`` tokens of headroom.  Templated and repetitive
    traffic repeats its own phrases, so the continuation after a
    repeated n-gram is a strong guess — and it costs zero parameters
    and zero device compute."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"({min_ngram}, {max_ngram})")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def draft(self, tokens: Sequence[int], k: int) -> List[int]:
        toks = list(tokens)
        n_tok = len(toks)
        if k <= 0 or n_tok < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, n_tok - 1),
                       self.min_ngram - 1, -1):
            tail = toks[n_tok - n:]
            best: List[int] = []
            for i in range(n_tok - n - 1, -1, -1):
                if toks[i:i + n] == tail:
                    cont = toks[i + n:i + n + k]
                    if len(cont) >= k:
                        return cont  # most recent FULL-length match
                    if not best:
                        best = cont  # most recent match, kept as fallback
            if best:
                return best
        return []


class ModelDrafter:
    """Tiny-draft-model hook behind the same protocol: wraps any
    ``fn(tokens, k) -> proposed tokens`` callable (a distilled model's
    host-side greedy loop, a trie over corpus statistics, ...).  The
    engine neither knows nor cares — greedy verification keeps the
    output stream exact either way."""

    def __init__(self, fn: Callable[[Sequence[int], int], Sequence[int]]):
        self._fn = fn

    def draft(self, tokens: Sequence[int], k: int) -> List[int]:
        return [int(t) for t in self._fn(tokens, k)][:k]


#: registry for ``HVD_TPU_SERVE_SPEC_DRAFTER`` (docs/running.md)
_DRAFTERS = {
    "prompt_lookup": PromptLookupDrafter,
}


def make_drafter(name: str) -> Drafter:
    """Construct a registered drafter by name (the env-var spelling)."""
    try:
        return _DRAFTERS[name]()
    except KeyError:
        raise ValueError(
            f"unknown drafter {name!r}; registered: "
            f"{sorted(_DRAFTERS)}") from None


def accept_greedy(draft: Sequence[int],
                  verifier_argmax: Sequence[int]) -> Tuple[List[int], int]:
    """Greedy accept/reject: the exactness-preserving rule.

    ``verifier_argmax[i]`` is the verifier's greedy token at the
    position draft[i] was fed (so ``verifier_argmax`` has
    ``len(draft) + 1`` entries: one per draft position plus the bonus
    position after the last draft token).  The leading run where
    ``draft[i] == verifier_argmax[i]`` is accepted; the first
    disagreement is replaced by the verifier's own token — which is
    BY CONSTRUCTION what non-speculative greedy decode would have
    emitted there, because every accepted prefix position fed the
    verifier the same token greedy decode would have.  When the whole
    draft is accepted, the bonus position's argmax rides along free
    (the verify step already computed it).  Returns
    ``(emitted_tokens, n_accepted)``: ``len(emitted) == n_accepted + 1``
    always — a fully rejected draft still emits one token, so a
    speculative step never emits less than plain decode."""
    m = 0
    for d, v in zip(draft, verifier_argmax):
        if int(d) != int(v):
            break
        m += 1
    emitted = [int(t) for t in draft[:m]] + [int(verifier_argmax[m])]
    return emitted, m
