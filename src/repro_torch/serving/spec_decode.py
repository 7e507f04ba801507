"""Speculative decoding drafters (counterpart of `repro.serving.spec_decode`).

A drafter proposes up to k continuation tokens per live slot; the engine
scores the pending token plus the drafts of every slot in one batched
`verify_chunk` forward and keeps the longest prefix that agrees with its
own greedy choice, plus one bonus token. Greedy output is therefore
identical with speculation on or off; a drafter changes only how many
target forwards a request costs.

`PromptLookupDrafter` (n-gram lookup over the request's own prompt and
output) and `prompt_lookup` are line-for-line copies of the JAX package's:
that module imports jax, so the port keeps its own copy. QUEST's answers
copy spans of the retrieved evidence, which is why prompt lookup is the
default drafter of the served path.

Drafters see the engine through a narrow protocol: `on_insert(slot, req)`
and `on_free(slot)` track slot lifecycle, `draft_round(reqs, k_eff)`
returns {slot: [token, ...]} proposals (len <= k_eff[slot]). Any object
with that shape can be passed as `spec_decode=`.

The draft-model drafter runs a second model on the slab layout, which is
not ported yet, and raises NotImplementedError.
"""
from __future__ import annotations


def prompt_lookup(context: list, k: int, ngram: int = 3) -> list:
    """Propose up to `k` tokens continuing `context` by n-gram lookup.

    Tries the longest n-gram first (n = `ngram` down to 1); for a given n,
    scans matches from most recent to oldest and keeps the first one with a
    full k-token continuation, falling back to the longest continuation
    seen. Contexts shorter than the n-gram window simply try shorter
    n-grams (and return [] when nothing matches). Never proposes past the
    end of the context."""
    n_ctx = len(context)
    for n in range(min(ngram, n_ctx - 1), 0, -1):
        g = tuple(context[-n:])
        best = None
        for i in range(n_ctx - n - 1, -1, -1):
            if tuple(context[i:i + n]) == g:
                cont = context[i + n:i + n + k]
                if best is None or len(cont) > len(best):
                    best = cont
                if len(cont) == k:
                    break
        if best:
            return list(best)
    return []


class PromptLookupDrafter:
    """Model-free drafting from the request's own token context."""

    def __init__(self, *, ngram: int = 3):
        self.ngram = max(1, int(ngram))
        self.stats = {"draft_model_steps": 0}

    def on_insert(self, slot: int, req) -> None:
        pass

    def on_free(self, slot: int) -> None:
        pass

    def draft_round(self, reqs: dict, k_eff: dict) -> dict:
        out = {}
        for slot, req in reqs.items():
            k = k_eff.get(slot, 0)
            if k <= 0:
                out[slot] = []
                continue
            context = list(req.prompt) + list(req.out)
            out[slot] = prompt_lookup(context, k, self.ngram)
        return out


class DraftModelDrafter:
    """Draft-model drafting: a small second model proposes continuations.
    It keeps its own slab decode cache (kernel K5 on the card), which the
    port does not have yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "spec_decode='draft' (DraftModelDrafter) is not yet ported, see "
            "ROADMAP.md Queue 1")
