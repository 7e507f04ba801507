"""Speculative decoding drafters (counterpart of `repro.serving.spec_decode`).

A drafter proposes up to k continuation tokens per live slot; the engine
scores the pending token plus the drafts of every slot in one batched
verify forward and keeps the longest prefix that agrees with its own
greedy choice, plus one bonus token. Greedy output is therefore identical
with speculation on or off; a drafter changes only how many target
forwards a request costs.

`PromptLookupDrafter` (n-gram lookup over the request's own prompt and
output) and `prompt_lookup` are line-for-line copies of the JAX package's:
that module imports jax, so the port keeps its own copy. QUEST's answers
copy spans of the retrieved evidence, which is why prompt lookup is the
default drafter of the served path.

`DraftModelDrafter` runs a second model (dense; the draft may be the
target itself, self-drafting, the acceptance ceiling) on its own batched
slab decode cache, line for line as the JAX drafter: each prompt prefills
bucketed to `chunk_size` (kernel K2 on the card), each draft step is a
batched slab decode step (kernel K5), and rows resynchronise to the
target's kept history by common prefix at the start of every round. It
keeps a host mirror of the cache positions, where the JAX drafter reads
them back from the device twice a round.

Drafters see the engine through a narrow protocol: `on_insert(slot, req)`
and `on_free(slot)` track slot lifecycle, `draft_round(reqs, k_eff)`
returns {slot: [token, ...]} proposals (len <= k_eff[slot]). Any object
with that shape can be passed as `spec_decode=`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import decode_step_slab, init_decode_cache, prefill
from repro_torch.models.cache_ops import write_slot
from repro_torch.models.config import ModelConfig


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

    The draft model runs its own batched slab decode cache (one row per
    engine slot). Each round it first catches up on tokens the target fed
    that the draft has not (at most the previous round's last draft token,
    on full acceptance), then feeds the pending token and k-1 of its own
    greedy proposals to produce k draft tokens. Rows are resynchronized to
    the target's kept history by common-prefix comparison at the start of
    every round, which makes rollback self-healing across partial
    acceptance, drain/requeue, and slot reuse.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int,
                 max_len: int, chunk_size: int = 32, mesh=None, device=None):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(
                f"draft model family must be dense/moe (attention KV rollback "
                f"is a position reset); got {cfg.family!r}")
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving is not yet ported, see ROADMAP.md Queue 1")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.chunk_size = max(1, int(chunk_size))
        self.device = resolve_device(device)
        self.cache = init_decode_cache(cfg, slots, max_len, device=self.device)
        self.cache["pos"] = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        self._pos_h = np.zeros((slots,), np.int64)          # host mirror of pos
        self._hist: dict = {s: [] for s in range(slots)}   # tokens fed per row
        self.stats = {"draft_model_steps": 0, "draft_prefill_tokens": 0}

    def _set_pos(self, pos) -> None:
        self._pos_h = pos
        self.cache["pos"] = torch.as_tensor(pos.astype(np.int32), device=self.device)

    # ---------------------------------------------------------- lifecycle --

    def on_insert(self, slot: int, req) -> None:
        prompt = [int(t) % self.cfg.vocab_size for t in req.prompt]
        n = len(prompt)
        assert n < self.max_len, (
            f"prompt ({n}) exceeds draft cache max_len={self.max_len}")
        b = self.chunk_size
        bucket = min(((n + b - 1) // b) * b, self.max_len)
        toks = torch.as_tensor([prompt + [0] * (bucket - n)], dtype=torch.int64,
                               device=self.device)
        _, sub = prefill(self.cfg, self.params, toks, self.max_len, length=n)
        write_slot(self.cache, sub, slot)
        self._pos_h[slot] = n
        self._hist[slot] = prompt
        self.stats["draft_prefill_tokens"] += n

    def on_free(self, slot: int) -> None:
        self._hist[slot] = []

    # ----------------------------------------------------------- drafting --

    def draft_round(self, reqs: dict, k_eff: dict) -> dict:
        V = self.cfg.vocab_size
        feeds, props, want = {}, {}, {}
        for slot, req in reqs.items():
            # resync: the longest prefix of this row's fed tokens that is
            # still the target's kept history (rollback after rejection)
            target = ([int(t) % V for t in req.prompt] +
                      [int(t) % V for t in req.out[:-1]])
            hist = self._hist[slot]
            v = 0
            while v < len(hist) and v < len(target) and hist[v] == target[v]:
                v += 1
            self._hist[slot] = hist = target[:v]
            lag = target[v:]
            k = min(k_eff.get(slot, 0),
                    self.max_len - 1 - len(target) - 1)
            props[slot] = []
            if k <= 0:
                feeds[slot] = []
                want[slot] = 0
                continue
            pending = int(req.out[-1]) % V
            feeds[slot] = lag + [pending]
            want[slot] = k
        steps = max((len(feeds[s]) + max(want[s] - 1, 0)
                     for s in feeds), default=0)
        if steps == 0:
            return props
        # roll every participating row back to its valid fed length
        pos = self._pos_h.copy()
        for slot in feeds:
            pos[slot] = len(self._hist[slot])
        self._set_pos(pos)
        for _ in range(steps):
            row_tok = np.zeros((self.slots, 1), np.int64)
            fed_now = {}
            for slot in feeds:
                if feeds[slot]:
                    tok = feeds[slot].pop(0)
                elif len(props[slot]) < want[slot] and props[slot]:
                    tok = props[slot][-1]
                else:
                    continue                     # row done: dummy zero feed
                row_tok[slot, 0] = tok
                fed_now[slot] = tok
                self._hist[slot].append(tok)
            logits, self.cache = decode_step_slab(
                self.cfg, self.params, torch.as_tensor(row_tok, device=self.device),
                self.cache)
            self._pos_h = self._pos_h + 1
            self.stats["draft_model_steps"] += 1
            nxt = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
            for slot in list(fed_now):
                if not feeds[slot] and len(props[slot]) < want[slot]:
                    props[slot].append(int(nxt[slot]))
        # drop rows' pos back to their true fed length (dummy feeds advanced
        # every row; garbage KV past pos is masked and overwritten later)
        pos = self._pos_h.copy()
        for slot in props:
            pos[slot] = len(self._hist[slot])
        self._set_pos(pos)
        return props
