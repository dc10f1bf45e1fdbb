"""Draft proposers for speculative serving decode (``ServingConfig.spec_tokens``).

A drafter has one method, ``propose(feed, k) -> list[int]``: up to ``k``
candidate continuations of ``feed`` (prompt + everything emitted so far),
possibly fewer or none.  Correctness never depends on the drafts — the target
verifies every window position in the decode dispatch — only the acceptance
rate does.  Two drafters: prompt-lookup n-grams (:class:`NgramDrafter`, the
default) and a small draft model's greedy forward (:class:`DraftModelDrafter`).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["DraftModelDrafter", "NgramDrafter"]


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


def _first_tensor(tree) -> Optional[torch.Tensor]:
    """The first tensor of a nested dict/sequence of parameters."""
    if torch.is_tensor(tree):
        return tree
    for leaf in (tree.values() if isinstance(tree, dict) else tree):
        found = _first_tensor(leaf)
        if found is not None:
            return found
    return None


class DraftModelDrafter:
    """Greedy proposals from a small draft model's full forward.

    ``apply`` is a model-family forward ``apply(params, ids, config,
    attention_mask=...) -> logits [B, S, V]`` (``llama.apply``).  Each feed
    is right-padded to the next power of two (capped at ``max_len``, by
    default the config's ``max_seq_len``) with the padding masked out of the
    keys, and the next token is the argmax at the last real row; the
    forward runs under ``torch.no_grad()`` on the device ``params`` live
    on.  One proposal is one forward and one read of its token."""

    def __init__(self, apply, params, config, max_len: Optional[int] = None):
        self._apply = apply
        self.params = params
        self.config = config
        self._max_len = int(max_len) if max_len else getattr(config, "max_seq_len", None)
        first = _first_tensor(params)
        if first is None:
            raise ValueError("draft params hold no tensor")
        self._device = first.device

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    @torch.no_grad()
    def propose(self, feed: Sequence[int], k: int) -> List[int]:
        toks = [int(t) for t in feed]
        out: List[int] = []
        for _ in range(max(int(k), 0)):
            n = len(toks)
            if self._max_len is not None and n >= self._max_len:
                break
            bucket = self._bucket(n)
            if self._max_len is not None:
                bucket = min(bucket, self._max_len)
            ids = np.zeros((1, bucket), np.int64)
            ids[0, :n] = toks
            ids_t = torch.from_numpy(ids).to(self._device)
            mask = (torch.arange(bucket, device=self._device) < n)[None]
            logits = self._apply(self.params, ids_t, self.config, attention_mask=mask)
            nxt = int(logits[0, n - 1].argmax())
            out.append(nxt)
            toks.append(nxt)
        return out
