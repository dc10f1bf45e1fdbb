"""Draft proposers for speculative serving decode (``ServingConfig.spec_tokens``).

A drafter has one method, ``propose(feed, k) -> list[int]``: up to ``k``
candidate continuations of ``feed`` (prompt + everything emitted so far),
possibly fewer or none.  Correctness never depends on the drafts — the target
verifies every window position in the decode dispatch — only the acceptance
rate does.  The draft-model drafter of the JAX package is not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = ["NgramDrafter"]


class NgramDrafter:
    """Prompt-lookup drafts: propose the continuation that followed the most
    recent earlier occurrence of the feed's trailing n-gram.

    Tries match lengths ``max_ngram`` down to ``min_ngram`` (longer first),
    scanning for the latest earlier occurrence.  Among occurrences of one
    n-gram, the latest whose continuation is a full ``k`` tokens wins over a
    later but truncated one (in a short repetition loop the most recent
    match sits at the end of the feed, where its continuation runs out)."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1:
            raise ValueError(f"min_ngram must be >= 1, got {min_ngram}")
        if max_ngram < min_ngram:
            raise ValueError(f"max_ngram ({max_ngram}) must be >= min_ngram ({min_ngram})")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, feed: Sequence[int], k: int) -> List[int]:
        toks = list(feed)
        n_feed = len(toks)
        if k <= 0 or n_feed < self.min_ngram + 1:
            return []
        for n in range(min(self.max_ngram, n_feed - 1), self.min_ngram - 1, -1):
            suffix = toks[-n:]
            best: List[int] = []
            for i in range(n_feed - n - 1, -1, -1):
                if toks[i:i + n] == suffix:
                    cont = toks[i + n:i + n + k]
                    if len(cont) >= k:
                        return [int(t) for t in cont]
                    if len(cont) > len(best):
                        best = [int(t) for t in cont]
            if best:
                return best
        return []
