"""Deterministic PyTorch text embedder (E5 stand-in; counterpart of
`repro.index.embedder`).

Hashed unigram+bigram features -> fixed random projection -> L2 normalize.
Cosine similarity of the embeddings tracks lexical/phrasal overlap, which is
what the two-level index and evidence augmentation exploit.

The projection: the JAX package draws it from
`jax.random.normal(PRNGKey(42), (4096, 256)) / sqrt(256)`, which torch
cannot reproduce. `proj=` takes it as an argument (the parity tests pass
the JAX draw); without it the default is a *different* draw of the same
distribution, normal / sqrt(dim) from a `torch.Generator` seeded with
`seed`, made on the CPU so it is the same on every device.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from repro_torch.data.tokens import words
from repro_torch.device import resolve_device

N_FEATURES = 4096
EMBED_DIM = 256


def _hash(token: str) -> int:
    return int.from_bytes(hashlib.blake2b(token.encode(), digest_size=4).digest(), "little")


def _feature_counts(text: str) -> np.ndarray:
    ws = words(text)
    v = np.zeros((N_FEATURES,), np.float32)
    for w in ws:
        v[_hash(w) % N_FEATURES] += 1.0
    for a, b in zip(ws, ws[1:]):
        v[_hash(a + "_" + b) % N_FEATURES] += 0.5
    return v


def default_projection(dim: int = EMBED_DIM, seed: int = 42) -> torch.Tensor:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn((N_FEATURES, dim), generator=gen,
                       dtype=torch.float32) / np.sqrt(dim)


class HashedEmbedder:
    """Deterministic tf-idf hashed embedder. `fit(texts)` learns bucket idf
    weights over a reference collection (the corpus segments), which is what
    gives document/domain separation; without fit, idf=1."""

    def __init__(self, dim: int = EMBED_DIM, seed: int = 42, *, proj=None,
                 device=None):
        self.dim = dim
        self.device = resolve_device(device)
        proj = default_projection(dim, seed) if proj is None else \
            torch.from_numpy(np.array(proj, np.float32))    # a writable copy
        if tuple(proj.shape) != (N_FEATURES, dim):
            raise ValueError(f"projection must be ({N_FEATURES}, {dim}), "
                             f"got {tuple(proj.shape)}")
        self._proj = proj.to(self.device)
        self._idf = np.ones((N_FEATURES,), np.float32)

    def fit(self, texts: list[str]):
        df = np.zeros((N_FEATURES,), np.float32)
        for t in texts:
            nz = _feature_counts(t) > 0
            df += nz
        n = max(len(texts), 1)
        self._idf = np.log((n + 1.0) / (df + 1.0)).astype(np.float32) + 1.0
        return self

    def _project(self, feats: np.ndarray) -> np.ndarray:
        emb = torch.from_numpy(feats).to(self.device) @ self._proj
        norm = torch.sqrt((emb * emb).sum(-1, keepdim=True))
        return (emb / torch.clamp(norm, min=1e-6)).cpu().numpy()

    def embed(self, texts: list[str], _chunk: int = 1024) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        outs = []
        for i in range(0, len(texts), _chunk):
            feats = np.stack([_feature_counts(t) for t in texts[i:i + _chunk]])
            # (1 + log tf) * idf
            feats = np.log1p(feats) * self._idf[None, :]
            outs.append(self._project(feats))
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def embed_one(self, text: str) -> np.ndarray:
        return self.embed([text])[0]
