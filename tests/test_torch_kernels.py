"""Plain PyTorch versions of the port's kernels (K1 paged decode attention,
K2 paged chunk-prefill attention and its non-causal form, K3 L2 top-k, K4
paged verify attention, K5 dense decode attention)
against the JAX package's
Pallas kernels in interpret mode and its jnp references, on the same
numpy inputs; and the span plan of the paged-attention core that K1, K2,
K4 and K5 share, with a float32 emulation of its split and merge. The CUDA
kernels themselves are held against these plain versions on the card by
`chip_smoke.py`."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention_pallas, paged_decode_attention_ref,
    paged_verify_attention_pallas, paged_verify_attention_ref)
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.topk_l2 import topk_l2_pallas  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.kernels import decode_attention as k1  # noqa: E402
from repro_torch.kernels import flash_attention as k2  # noqa: E402
from repro_torch.kernels import topk_l2 as k3  # noqa: E402
from repro_torch.kernels import verify_attention as k4  # noqa: E402

F32_TOL = 2e-5
TOPK_TOL = 1e-4


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------- K1 paged decode ---


@pytest.mark.parametrize("B,H,Hkv,D,P,ps,nb", [
    (2, 4, 2, 64, 16, 16, 4),
    (3, 8, 1, 32, 12, 8, 3),
])
def test_paged_decode_plain_matches_pallas(B, H, Hkv, D, P, ps, nb):
    rng = np.random.default_rng(0)
    q = _rand(rng, (B, H, D))
    kp = _rand(rng, (P, ps, Hkv, D))
    vp = _rand(rng, (P, ps, Hkv, D))
    table = rng.permutation(P)[: B * nb].reshape(B, nb).astype(np.int32)
    lengths = np.asarray([(nb * ps * (i + 1)) // (B + 1) for i in range(B)], np.int32)
    want = np.asarray(paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), interpret=True))
    want_ref = np.asarray(paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths)))
    got = k1.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lengths))
    assert got.shape == (B, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=F32_TOL, rtol=F32_TOL)
    assert k1.launches == 0          # a CPU tensor never reaches the kernel


def test_paged_decode_dead_row_and_zero_length():
    """A dead slot's length runs past its table (nb * ps); the page walk is
    bounded by the table and the row attends every position it maps. A
    zero length sees no key and gives zeros."""
    rng = np.random.default_rng(1)
    B, H, Hkv, D, P, ps, nb = 3, 4, 2, 32, 8, 4, 2
    q = _rand(rng, (B, H, D))
    kp = _rand(rng, (P, ps, Hkv, D))
    vp = _rand(rng, (P, ps, Hkv, D))
    table = np.asarray([[3, 5], [0, 0], [1, 2]], np.int32)   # row 1: sink
    lengths = np.asarray([6, 57, 0], np.int32)
    got = k1.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                    _t(lengths)).numpy()
    full = np.asarray([6, nb * ps, 1], np.int32)
    want = np.asarray(paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(full)))
    np.testing.assert_allclose(got[:2], want[:2], atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_array_equal(got[2], np.zeros((H, D), np.float32))


def test_paged_decode_plain_matches_model_decode_attention():
    """Against the jnp attention the JAX engine runs over its gathered view
    (`layers.decode_attention` with per-row lengths)."""
    rng = np.random.default_rng(2)
    B, H, Hkv, D, P, ps, nb = 4, 4, 2, 16, 20, 16, 4
    q = _rand(rng, (B, H, D))
    kp = _rand(rng, (P, ps, Hkv, D))
    vp = _rand(rng, (P, ps, Hkv, D))
    table = rng.permutation(np.arange(1, P))[: B * nb].reshape(B, nb).astype(np.int32)
    lengths = np.asarray([1, 17, 33, 64], np.int32)
    kg = kp[table].reshape(B, nb * ps, Hkv, D)
    vg = vp[table].reshape(B, nb * ps, Hkv, D)
    want = np.asarray(jl.decode_attention(
        jnp.asarray(q).reshape(B, 1, Hkv, H // Hkv, D), jnp.asarray(kg),
        jnp.asarray(vg), jnp.asarray(lengths))).reshape(B, H, D)
    got = k1.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lengths))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


# ------------------------------------------------- K2 chunk prefill ------


@pytest.mark.parametrize("S,H,Hkv,D,ps", [(64, 4, 2, 32, 16), (128, 2, 1, 64, 32)])
def test_chunk_prefill_plain_matches_flash_pallas(S, H, Hkv, D, ps):
    """start = 0 with an identity page table over a contiguous cache is
    flash_attention_pallas(causal=True) with Sq = Skv."""
    rng = np.random.default_rng(3)
    q = _rand(rng, (1, S, H, D))
    k = _rand(rng, (1, S, Hkv, D))
    v = _rand(rng, (1, S, Hkv, D))
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        bq=S // 2, bk=S // 2, interpret=True))[0]
    want_ref = np.asarray(ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))[0]
    kp = k[0].reshape(S // ps, ps, Hkv, D)
    vp = v[0].reshape(S // ps, ps, Hkv, D)
    ident = np.arange(S // ps, dtype=np.int32)
    got = k2.chunk_prefill_attention(_t(q[0]), _t(kp), _t(vp), _t(ident), 0).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(got, want_ref, atol=F32_TOL, rtol=F32_TOL)
    assert k2.launches == 0


@pytest.mark.parametrize("start,C", [(0, 8), (21, 8), (40, 16)])
def test_chunk_prefill_plain_offset_paged(start, C):
    """A chunk at positions [start, start+C) over scattered pages against
    `layers.sdpa(..., q_offset=start)` over the gathered view."""
    rng = np.random.default_rng(4)
    H, Hkv, D, ps, P, n_ctx = 4, 2, 16, 8, 16, 8
    q = _rand(rng, (C, H, D))
    kp = _rand(rng, (P, ps, Hkv, D))
    vp = _rand(rng, (P, ps, Hkv, D))
    ctx = rng.permutation(P)[:n_ctx].astype(np.int32)
    kg = kp[ctx].reshape(1, n_ctx * ps, Hkv, D)
    vg = vp[ctx].reshape(1, n_ctx * ps, Hkv, D)
    want = np.asarray(jl.sdpa(
        jnp.asarray(q).reshape(1, C, Hkv, H // Hkv, D), jnp.asarray(kg),
        jnp.asarray(vg), causal=True, q_offset=start)).reshape(C, H, D)
    got = k2.chunk_prefill_attention(_t(q), _t(kp), _t(vp), _t(ctx), start).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


# ------------------------- K1/K2 in bf16 at the kernels' GQA packing ------
# G = 8 query heads per KV head, head_dim 128, pages of 16: the shapes the
# paged-attention core packs into one 16-row tile (K1) or 64-row tiles (K2).
BF16_TOL = 2e-2


def _bf16(rng, shape):
    """Seeded normals rounded to bf16, as float32 numpy (exact in bf16)."""
    return np.asarray(jnp.asarray(_rand(rng, shape)).astype(jnp.bfloat16), np.float32)


def test_paged_decode_plain_bf16_matches_pallas():
    rng = np.random.default_rng(9)
    B, H, Hkv, D, P, ps, nb = 3, 16, 2, 128, 14, 16, 4
    q, kp, vp = _bf16(rng, (B, H, D)), _bf16(rng, (P, ps, Hkv, D)), _bf16(rng, (P, ps, Hkv, D))
    table = rng.permutation(P)[: B * nb].reshape(B, nb).astype(np.int32)
    lengths = np.asarray([1, 37, nb * ps], np.int32)
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, kp, vp)]
    want = np.asarray(paged_decode_attention_pallas(
        *jargs, jnp.asarray(table), jnp.asarray(lengths), interpret=True), np.float32)
    want_ref = np.asarray(paged_decode_attention_ref(
        *jargs, jnp.asarray(table), jnp.asarray(lengths)), np.float32)
    got = k1.paged_decode_attention(*[_t(a).bfloat16() for a in (q, kp, vp)], _t(table),
                                    _t(lengths))
    assert got.dtype == torch.bfloat16 and k1.launches == 0
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(got.float().numpy(), want_ref, atol=BF16_TOL, rtol=BF16_TOL)


def test_chunk_prefill_plain_bf16_matches_flash_pallas():
    """start = 0 over an identity table: flash_attention_pallas(causal=True)."""
    rng = np.random.default_rng(10)
    S, H, Hkv, D, ps = 64, 16, 2, 128, 16
    q, k, v = _bf16(rng, (1, S, H, D)), _bf16(rng, (1, S, Hkv, D)), _bf16(rng, (1, S, Hkv, D))
    jq, jk, jv = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(flash_attention_pallas(jq, jk, jv, causal=True, bq=32, bk=32,
                                             interpret=True), np.float32)[0]
    want_ref = np.asarray(ref.flash_attention_ref(jq, jk, jv, causal=True), np.float32)[0]
    kp, vp = k[0].reshape(S // ps, ps, Hkv, D), v[0].reshape(S // ps, ps, Hkv, D)
    ident = np.arange(S // ps, dtype=np.int32)
    got = k2.chunk_prefill_attention(_t(q[0]).bfloat16(), _t(kp).bfloat16(),
                                     _t(vp).bfloat16(), _t(ident), 0)
    assert got.dtype == torch.bfloat16 and k2.launches == 0
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(got.float().numpy(), want_ref, atol=BF16_TOL, rtol=BF16_TOL)


def test_chunk_prefill_plain_bf16_ragged_offset():
    """C = 37 (a ragged last tile) at a start that is not page-aligned, over
    scattered pages, against the JAX engine's `layers.sdpa` in bf16."""
    rng = np.random.default_rng(11)
    start, C, H, Hkv, D, ps, P, n_ctx = 21, 37, 16, 2, 128, 16, 9, 4
    q, kp, vp = _bf16(rng, (C, H, D)), _bf16(rng, (P, ps, Hkv, D)), _bf16(rng, (P, ps, Hkv, D))
    ctx = rng.permutation(P)[:n_ctx].astype(np.int32)
    kg = jnp.asarray(kp[ctx].reshape(1, n_ctx * ps, Hkv, D)).astype(jnp.bfloat16)
    vg = jnp.asarray(vp[ctx].reshape(1, n_ctx * ps, Hkv, D)).astype(jnp.bfloat16)
    want = np.asarray(jl.sdpa(jnp.asarray(q).astype(jnp.bfloat16).reshape(1, C, Hkv, H // Hkv, D),
                              kg, vg, causal=True, q_offset=start), np.float32).reshape(C, H, D)
    got = k2.chunk_prefill_attention(_t(q).bfloat16(), _t(kp).bfloat16(), _t(vp).bfloat16(),
                                     _t(ctx), start)
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL, rtol=BF16_TOL)


# ------------------------------ the paged-attention core's span plan ------


def _span_keys(plan, split, limit, cap):
    """The key positions span `split` visits for a query row that sees the
    positions < `limit`, as paged_attention.cuh walks them: from k_begin =
    split * span to span_end = min(k_begin + span, cap), where cap is the
    table's nb * ps, and not past the row's limit (K1: its raw length)."""
    return range(split * plan.span, min((split + 1) * plan.span, cap, limit))


@pytest.mark.parametrize("G,C,groups,n_keys", [
    (8, 1, 8, 1024),      # K1 at qwen2.5-3b width: 4 rows x 2 KV heads, 64 pages of 16
    (1, 1, 1, 5),
    (2, 1, 24, 192),
    (32, 1, 2, 4096),
    (8, 32, 2, 896),      # K2: a 32-token chunk at start 864
    (8, 512, 2, 512),     # K2: a whole 512-token prompt (the slab layout)
    (4, 37, 2, 358),      # K2: a ragged chunk at a start that is not page-aligned
    (8, 2, 1, 64),
    (8, 5, 8, 1024),      # K4 at qwen2.5-3b width: 5 candidates, 4 rows x 2 KV heads
    (16, 5, 2, 700),      # K4: 80 rows, two query tiles, the last ragged
    (6, 1, 32, 1024),     # K1 at nemotron-4-15b width: group 6, 4 rows x 8 KV heads
    (6, 3, 32, 1024),     # K4, group 6: 18 rows, past one 16-row tile
    (6, 5, 32, 4096),     # K4, group 6: 30 rows
    (4, 3008, 8, 3008),   # K2: llava's first chunk, 2,880 image + 128 text positions
    (4, 5, 32, 4096),     # K4 at llava width over its image prefix
    (1, 1500, 16, 1500),  # K2 non-causal: whisper's encoder, 16 heads over 16
    (1, 128, 16, 1500),   # K2 non-causal: a cross-attention chunk
    (1, 5, 64, 1500),     # K2 non-causal: a verify round's cross-attention, 4 slots
])
def test_span_plan_partitions_visible_keys(G, C, groups, n_keys):
    plan = k1.plan_spans(G * C, groups, n_keys)
    tiles = -(-n_keys // k1.KEY_TILE)
    assert plan.key_groups == (4 if G * C <= 16 else 1)
    assert plan.span % k1.KEY_TILE == 0 and plan.span > 0
    # the limits the C entry points check: every key covered, no idle span
    assert 1 <= plan.nsplit <= tiles
    assert plan.nsplit * plan.span >= n_keys > (plan.nsplit - 1) * plan.span
    qtiles = -(-G * C // (k1.BLOCK_ROWS // plan.key_groups))
    assert groups * qtiles * plan.nsplit < k1.TARGET_BLOCKS + groups * qtiles
    # every visible key in exactly one span, none at or past the walk's end
    for limit in sorted({0, 1, n_keys // 3, n_keys - 1, n_keys}):
        seen = [k for s in range(plan.nsplit) for k in _span_keys(plan, s, limit, n_keys)]
        assert sorted(seen) == list(range(limit))
    # a dead row (length far past its table) visits each key of its table
    # once and stops at nb * ps; a zero length gives no work
    dead = [k for s in range(plan.nsplit) for k in _span_keys(plan, s, n_keys * 3, n_keys)]
    assert sorted(dead) == list(range(n_keys))
    assert not any(_span_keys(plan, s, 0, n_keys) for s in range(plan.nsplit))


def _state(q, k, v, scale):
    """(max, denominator, acc) of one query row over some keys."""
    if not len(k):
        return -float("inf"), 0.0, torch.zeros_like(q)
    sc = (k @ q) * scale
    m = float(sc.max())
    p = torch.exp(sc - m)
    return m, float(p.sum()), p @ v


def _rescaled(states):
    """Combine (max, denominator, acc) states as the kernels do: rescale
    each to the common max, in order; empty states (max -inf) add nothing."""
    m = max(sm for sm, _, _ in states)
    live = [(sm, sl, sa) for sm, sl, sa in states if sm != -float("inf")]
    w = [np.float32(np.exp(np.float32(sm - m))) for sm, _, _ in live]
    l = sum(float(sl) * float(x) for (_, sl, _), x in zip(live, w))
    acc = sum((sa * float(x) for (_, _, sa), x in zip(live, w)), torch.zeros_like(states[0][2]))
    return m, l, acc


def _split_merge(q, k, v, limits, plan, scale):
    """float32 emulation of the core on one (sequence, KV head): q (R, D)
    query rows with their key limits, k/v (S, D) the row's keys by logical
    position, S the walk's cap. In each span, key group kw (of plan.key_groups) takes
    positions 16 kw .. 16 kw + 15 of each 64-position tile when there are
    four; the block combines its groups' (max, denominator, acc) into the
    span's, and the merge combines the spans' and divides."""
    share = k1.KEY_TILE // plan.key_groups
    out = torch.zeros_like(q)
    for r in range(q.shape[0]):
        spans = []
        for s in range(plan.nsplit):
            keys = list(_span_keys(plan, s, int(limits[r]), k.shape[0]))
            groups = [[p for p in keys if (p % k1.KEY_TILE) // share == kw]
                      for kw in range(plan.key_groups)]
            spans.append(_rescaled([_state(q[r], k[g], v[g], scale) for g in groups]))
        _, l, acc = _rescaled(spans)
        out[r] = acc / max(l, 1e-30)
    return out


def test_split_merge_emulation_matches_paged_decode_plain():
    """K1's plan at a dead row, a zero length and lengths inside and across
    tiles, split over spans and key groups, merged: equals the plain
    version."""
    rng = np.random.default_rng(12)
    B, H, Hkv, D, P, ps, nb = 4, 8, 2, 32, 40, 8, 24
    q, kp, vp = _rand(rng, (B, H, D)), _rand(rng, (P, ps, Hkv, D)), _rand(rng, (P, ps, Hkv, D))
    table = rng.integers(1, P, (B, nb)).astype(np.int32)
    table[1] = 0                                            # all-sink
    lengths = np.asarray([77, nb * ps * 3, 0, 150], np.int32)
    plan = k1.plan_spans(H // Hkv, B * Hkv, nb * ps)
    assert plan.nsplit > 1 and plan.key_groups == 4
    want = k1.paged_decode_attention_plain(_t(q), _t(kp), _t(vp), _t(table), _t(lengths))
    G, scale = H // Hkv, D ** -0.5
    got = torch.zeros_like(want)
    for b in range(B):
        limit = max(int(lengths[b]), 0)
        for kvh in range(Hkv):
            k = _t(kp)[_t(table[b]).long(), :, kvh].reshape(nb * ps, D)
            v = _t(vp)[_t(table[b]).long(), :, kvh].reshape(nb * ps, D)
            rows = slice(kvh * G, (kvh + 1) * G)
            got[b, rows] = _split_merge(_t(q)[b, rows], k, v, [limit] * G, plan, scale)
    np.testing.assert_array_equal(got[2].numpy(), np.zeros((H, D), np.float32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def test_split_merge_emulation_matches_chunk_prefill_plain():
    """K2's plan for a ragged 37-token chunk at start 45 (not page-aligned):
    each query row's causal limit start + c + 1."""
    rng = np.random.default_rng(13)
    start, C, H, Hkv, D, ps, P, n_ctx = 45, 37, 4, 2, 16, 8, 14, 11
    q, kp, vp = _rand(rng, (C, H, D)), _rand(rng, (P, ps, Hkv, D)), _rand(rng, (P, ps, Hkv, D))
    ctx = rng.permutation(P)[:n_ctx].astype(np.int32)
    G = H // Hkv
    plan = k1.plan_spans(G * C, Hkv, start + C)
    assert plan.nsplit > 1
    want = k2.chunk_prefill_attention_plain(_t(q), _t(kp), _t(vp), _t(ctx), start)
    got = torch.zeros_like(want)
    for kvh in range(Hkv):
        k = _t(kp)[_t(ctx).long(), :, kvh].reshape(n_ctx * ps, D)
        v = _t(vp)[_t(ctx).long(), :, kvh].reshape(n_ctx * ps, D)
        rows = _t(q)[:, kvh * G:(kvh + 1) * G].reshape(C * G, D)      # row = c * G + g
        limits = [start + r // G + 1 for r in range(C * G)]
        got[:, kvh * G:(kvh + 1) * G] = _split_merge(rows, k, v, limits, plan,
                                                     D ** -0.5).reshape(C, G, D)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def test_split_merge_emulation_matches_paged_verify_plain():
    """K4's plan: per-row starts -- one not page-aligned with its candidates
    crossing a page, a dead all-sink row at a stale start, start 0 -- rows
    ordered c * G + g, candidate c of row b limited to min(starts[b] + c +
    1, nb * ps), split over spans, merged: equals the plain version."""
    rng = np.random.default_rng(14)
    B, H, Hkv, C, D, P, ps, nb = 4, 8, 2, 5, 32, 40, 8, 24
    q, kp, vp = _rand(rng, (B, H, C, D)), _rand(rng, (P, ps, Hkv, D)), _rand(rng, (P, ps, Hkv, D))
    table = rng.integers(1, P, (B, nb)).astype(np.int32)
    table[1] = 0                                            # all-sink
    starts = np.asarray([77, nb * ps * 3, 0, 150], np.int32)  # 77..81 cross page 10
    G, cap = H // Hkv, nb * ps
    plan = k1.plan_spans(G * C, B * Hkv, cap)
    assert plan.nsplit > 1 and plan.key_groups == 1
    want = k4.paged_verify_attention_plain(_t(q), _t(kp), _t(vp), _t(table), _t(starts))
    got = torch.zeros_like(want)
    for b in range(B):
        limits = [min(int(starts[b]) + r // G + 1, cap) for r in range(C * G)]
        for kvh in range(Hkv):
            k = _t(kp)[_t(table[b]).long(), :, kvh].reshape(cap, D)
            v = _t(vp)[_t(table[b]).long(), :, kvh].reshape(cap, D)
            heads = slice(kvh * G, (kvh + 1) * G)
            rows = _t(q)[b, heads].transpose(0, 1).reshape(C * G, D)  # row = c * G + g
            got[b, heads] = _split_merge(rows, k, v, limits, plan, D ** -0.5) \
                .reshape(C, G, D).transpose(0, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def test_split_merge_emulation_matches_bidirectional_plain():
    """K2's non-causal plan on the identity layout: every row's limit is
    n_keys (here 137 of 150 keys, so the last span stops inside a tile),
    37 positions x G = 2 rows a KV head (a ragged second query tile), two
    batch rows: equals the plain version."""
    rng = np.random.default_rng(16)
    B, Sq, Skv, H, Hkv, D, n_keys = 2, 37, 150, 4, 2, 16, 137
    q = _rand(rng, (B, Sq, H, D))
    k, v = _rand(rng, (B, Skv, Hkv, D)), _rand(rng, (B, Skv, Hkv, D))
    G = H // Hkv
    plan = k1.plan_spans(G * Sq, B * Hkv, n_keys)
    assert plan.nsplit > 1 and plan.key_groups == 1
    want = k2.bidirectional_attention_plain(_t(q), _t(k), _t(v), n_keys)
    got = torch.zeros_like(want)
    for b in range(B):
        for kvh in range(Hkv):
            heads = slice(kvh * G, (kvh + 1) * G)
            rows = _t(q)[b, :, heads].reshape(Sq * G, D)              # row = c * G + g
            got[b, :, heads] = _split_merge(rows, _t(k)[b, :, kvh], _t(v)[b, :, kvh],
                                            [n_keys] * (Sq * G), plan,
                                            D ** -0.5).reshape(Sq, G, D)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


def test_split_merge_emulation_matches_dense_decode_plain():
    """K5's plan on the identity layout (row b's keys are its own slab row,
    one page of S) at an S that is not a multiple of the key tile, lengths
    1, S, S + 1 and 0: equals the plain version, the zero length exactly
    zeros."""
    rng = np.random.default_rng(15)
    B, H, Hkv, S, D = 4, 8, 2, 150, 32
    q, kc, vc = _rand(rng, (B, H, D)), _rand(rng, (B, S, Hkv, D)), _rand(rng, (B, S, Hkv, D))
    lengths = np.asarray([1, S, S + 1, 0], np.int32)
    G = H // Hkv
    plan = k1.plan_spans(G, B * Hkv, S)
    assert plan.nsplit > 1 and plan.key_groups == 4
    want = k1.decode_attention_plain(_t(q), _t(kc), _t(vc), _t(lengths))
    got = torch.zeros_like(want)
    for b in range(B):
        limit = min(int(lengths[b]), S)
        for kvh in range(Hkv):
            heads = slice(kvh * G, (kvh + 1) * G)
            got[b, heads] = _split_merge(_t(q)[b, heads], _t(kc)[b, :, kvh], _t(vc)[b, :, kvh],
                                         [limit] * G, plan, D ** -0.5)
    np.testing.assert_array_equal(got[3].numpy(), np.zeros((H, D), np.float32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


# ------------------------------------------------- K4 paged verify -------


@pytest.mark.parametrize("B,H,Hkv,C,D,P,ps,nb", [
    (2, 4, 2, 5, 64, 16, 128, 4),
    (3, 2, 1, 3, 128, 9, 256, 2),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_verify_plain_matches_pallas(B, H, Hkv, C, D, P, ps, nb, dtype):
    """The shapes of the JAX package's own K4 test, starts that cross a
    page boundary mid-candidates, plus a dead row (all-sink table, stale
    start) whose output is discarded by the engine but must be finite."""
    rng = np.random.default_rng(7)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q = _rand(rng, (B, H, C, D))
    kp = _rand(rng, (P, ps, Hkv, D))
    vp = _rand(rng, (P, ps, Hkv, D))
    table = rng.permutation(P)[: B * nb].reshape(B, nb).astype(np.int32)
    starts = np.asarray([(nb * ps * (i + 1)) // (B + 1) - C // 2 for i in range(B)],
                        np.int32)
    jargs = [jnp.asarray(a).astype(jdt) for a in (q, kp, vp)]
    want = np.asarray(paged_verify_attention_pallas(
        *jargs, jnp.asarray(table), jnp.asarray(starts), interpret=True), np.float32)
    want_ref = np.asarray(paged_verify_attention_ref(
        *jargs, jnp.asarray(table), jnp.asarray(starts)), np.float32)
    targs = [_t(np.array(a, np.float32)).to(tdt) for a in jargs]
    got = k4.paged_verify_attention(*targs, _t(table), _t(starts))
    assert got.shape == (B, H, C, D) and got.dtype == tdt
    tol = F32_TOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got.float().numpy(), want_ref, atol=tol, rtol=tol)
    # a dead row: all-sink table, start far past its table
    table_d, starts_d = table.copy(), starts.copy()
    table_d[0], starts_d[0] = 0, nb * ps * 3
    dead = k4.paged_verify_attention(*targs, _t(table_d), _t(starts_d))
    assert torch.isfinite(dead.float()).all()
    want_d = np.asarray(paged_verify_attention_ref(
        *jargs, jnp.asarray(table_d), jnp.asarray(starts_d)), np.float32)
    np.testing.assert_allclose(dead.float().numpy(), want_d, atol=tol, rtol=tol)
    assert k4.launches == 0


def test_paged_verify_plain_matches_model_chunk_attention():
    """Against the jnp attention the JAX engine's verify round runs over its
    gathered view (`layers.attn_chunk_apply`'s masked softmax with per-row
    starts), start 0 included."""
    rng = np.random.default_rng(8)
    B, H, Hkv, C, D, P, ps, nb = 3, 4, 2, 5, 16, 20, 8, 4
    q = _rand(rng, (B, H, C, D))
    kp = _rand(rng, (P, ps, Hkv, D))
    vp = _rand(rng, (P, ps, Hkv, D))
    table = rng.permutation(np.arange(1, P))[: B * nb].reshape(B, nb).astype(np.int32)
    starts = np.asarray([0, 13, nb * ps - C], np.int32)
    kg = kp[table].reshape(B, nb * ps, Hkv, D)
    vg = vp[table].reshape(B, nb * ps, Hkv, D)
    qg = q.transpose(0, 2, 1, 3).reshape(B, C, Hkv, H // Hkv, D)
    s = np.einsum("bqhgd,bshd->bhgqs", qg, kg) * D ** -0.5
    q_pos = starts[:, None] + np.arange(C)[None, :]
    ok = np.arange(nb * ps)[None, None, :] <= q_pos[:, :, None]
    s = np.where(ok[:, None, None], s, -np.inf)
    p = np.asarray(jax.nn.softmax(jnp.asarray(s), axis=-1))
    want = np.einsum("bhgqs,bshd->bqhgd", p, vg).reshape(B, C, H, D).transpose(0, 2, 1, 3)
    got = k4.paged_verify_attention(_t(q), _t(kp), _t(vp), _t(table), _t(starts))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


# ------------------------------------------------------------ K3 top-k ---


@pytest.mark.parametrize("N,D,M,k", [
    (300, 256, 5, 300),      # the retriever's shape: a full ranking, k = N
    (512, 64, 4, 5),
    (257, 32, 1, 1),
])
def test_topk_l2_plain_matches_pallas_and_ref(N, D, M, k):
    rng = np.random.default_rng(5)
    db = _rand(rng, (N, D))
    q = _rand(rng, (M, D))
    dr, ir = ref.topk_l2_ref(jnp.asarray(db), jnp.asarray(q), k)
    dp, _ = topk_l2_pallas(jnp.asarray(db), jnp.asarray(q), k, bm=4, bn=128,
                           interpret=True)
    d, i = k3.topk_l2(_t(db), _t(q), k)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_allclose(d.numpy(), np.asarray(dr), atol=TOPK_TOL, rtol=TOPK_TOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(dp), atol=TOPK_TOL, rtol=TOPK_TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))
    assert k3.launches == 0


def test_topk_l2_ties_lowest_index_first():
    """Duplicate database rows tie exactly; like lax.top_k, the lowest index
    comes first, across the whole k = N ranking."""
    rng = np.random.default_rng(6)
    base = _rand(rng, (40, 16))
    db = np.concatenate([base, base[::-1], base[:7]])       # many exact ties
    q = _rand(rng, (3, 16))
    q[1] = base[5]                                          # distance-0 ties
    N = len(db)
    dr, ir = ref.topk_l2_ref(jnp.asarray(db), jnp.asarray(q), N)
    d, i = k3.topk_l2(_t(db), _t(q), N)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ir))
    np.testing.assert_allclose(d.numpy(), np.asarray(dr), atol=TOPK_TOL, rtol=TOPK_TOL)
    for row_d, row_i in zip(d.numpy(), i.numpy()):
        for a in range(N - 1):
            if row_d[a] == row_d[a + 1]:
                assert row_i[a] < row_i[a + 1]


def _rank_by_count(d2: np.ndarray, k: int) -> np.ndarray:
    """K3's ranking as `csrc/topk_l2.cu` computes it, in numpy: the launch
    plan's blocks (a cluster's slices of `per` elements, or RANK_SPAN
    spans above CLUSTER_MAX_N), each block's warps in groups of 32
    elements times slices of the j range, partial counts added per element;
    key = d^2's float32 bits above the index. Returns the (M, k) indices
    written at each rank below k."""
    M, N = d2.shape
    plan = k3.topk_plan(N)
    if plan.cs:
        assert 1 <= plan.cs <= k3.MAX_CLUSTER and plan.cs * plan.per >= N
        assert (plan.cs - 1) * plan.per < N                    # no empty block
        spans = [(b * plan.per, min(N, (b + 1) * plan.per)) for b in range(plan.cs)]
    else:
        spans = [(lo, min(N, lo + k3.RANK_SPAN)) for lo in range(0, N, k3.RANK_SPAN)]
    nwarps = plan.threads // 32
    j = np.arange(N, dtype=np.uint64)
    out = np.full((M, k), -1, np.int64)
    for m in range(M):
        keys = (d2[m].astype(np.float32).view(np.uint32).astype(np.uint64) << np.uint64(32)) | j
        cnt = np.zeros(N, np.int64)
        for e_lo, e_hi in spans:
            groups = -(-(e_hi - e_lo) // 32)
            slices = nwarps // groups
            assert slices >= 1
            for w in range(groups * slices):
                g, s = w % groups, w // groups
                own = np.arange(e_lo + 32 * g, min(e_hi, e_lo + 32 * g + 32))
                j_lo, j_hi = N * s // slices, N * (s + 1) // slices
                cnt[own] += (keys[None, j_lo:j_hi] < keys[own, None]).sum(1)
        assert sorted(cnt) == list(range(N))                   # a permutation
        for e in range(N):
            if cnt[e] < k:
                out[m, cnt[e]] = e
    return out


@pytest.mark.parametrize("N,D,M,k,kind", [
    (309, 256, 4, 309, "random"),       # the retriever's launch
    (255, 32, 2, 255, "ties"),
    (256, 64, 1, 256, "near-ties"),
    (257, 32, 3, 100, "ties"),
    (2048, 32, 1, 2048, "near-ties"),   # the largest cluster
    (2049, 32, 2, 2049, "ties"),        # the two-kernel shape
    (40, 16, 2, 40, "random"),          # a cluster of 2
])
def test_topk_l2_rank_by_count_matches_ref(N, D, M, k, kind):
    """The kernel's order -- rank by counting over (d^2 bits, index) keys,
    split as its launch plan splits it -- against `topk_l2_ref`'s stable
    ranking (lax.top_k, lowest index first) on the same d^2: duplicated
    rows tie exactly, near-ties differ in the last bits."""
    rng = np.random.default_rng(N + D)
    if kind == "ties":
        base = _rand(rng, (N // 3 + 1, D))
        db = np.concatenate([base, base[::-1], base])[:N]
    else:
        db = _rand(rng, (N, D))
    q = _rand(rng, (M, D))
    if kind == "near-ties":            # pairs of rows one ulp apart in one coordinate
        db[1::2] = db[0::2][: N // 2]
        db[1::2, 0] = np.nextafter(db[1::2, 0], np.float32(np.inf))
        q[0] = db[7]
    d2 = np.asarray(jnp.sum((jnp.asarray(q)[:, None, :] - jnp.asarray(db)[None]) ** 2, -1))
    _, ir = ref.topk_l2_ref(jnp.asarray(db), jnp.asarray(q), k)
    got = _rank_by_count(d2, k)
    np.testing.assert_array_equal(got, np.asarray(ir))
    np.testing.assert_array_equal(got, np.argsort(d2, axis=1, kind="stable")[:, :k])
    gaps = np.diff(np.sort(d2, 1), axis=1)
    if kind == "ties":                 # the tie order was tested
        assert (gaps == 0).any()
    if kind == "near-ties":            # and the order of values a few ulps apart
        assert ((gaps > 0) & (gaps < 1e-6)).any()


def test_topk_l2_ops_copies_one_packed_buffer():
    """`ops.topk_l2` takes the packed (2, M, k) buffer -- distances, then
    the indices' int32 bits -- in one copy; its arrays equal the plain
    version's, with the same types."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(11)
    db, q = _rand(rng, (300, 32)), _rand(rng, (3, 32))
    packed = k3.topk_l2_packed(_t(db), _t(q), 50)
    d, i = k3.topk_l2_plain(_t(db), _t(q), 50)
    assert packed.shape == (2, 3, 50) and packed.dtype == torch.float32
    assert torch.equal(packed[0], d) and torch.equal(packed[1].view(torch.int32), i)
    hd, hi = ops.topk_l2(db, q, 50, device="cpu")
    assert hd.dtype == np.float32 and hi.dtype == np.int32
    np.testing.assert_array_equal(hd, d.numpy())
    np.testing.assert_array_equal(hi, i.numpy())
    assert k3.launches == 0


def test_no_silent_cpu_fallback():
    """Entry points default to the CUDA device and raise without one. A
    wrapper runs its plain version only by the device of the data: a meta
    tensor (the dry run's, storage-less) gets the plain version's result
    on the meta device -- shapes only, nothing computed on the CPU, no
    launch -- and inputs on two devices raise."""
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, device="meta", dtype=dtype)
    before = (k1.launches, k2.launches, k2.bidirectional_launches, k3.launches, k4.launches)
    d, i = k3.topk_l2(meta(16, 8), meta(2, 8), 3)
    assert (d.device.type, d.shape, i.dtype) == ("meta", (2, 3), torch.int32)
    with pytest.raises(ValueError):
        k3.topk_l2(torch.zeros((16, 8)), meta(2, 8), 3)
    table, lengths = meta(2, 4, dtype=torch.int32), meta(2, dtype=torch.int32)
    out = k1.paged_decode_attention(meta(2, 4, 16), meta(9, 8, 2, 16), meta(9, 8, 2, 16),
                                    table, lengths)
    assert (out.device.type, out.shape) == ("meta", (2, 4, 16))
    out = k4.paged_verify_attention(meta(2, 4, 3, 16), meta(9, 8, 2, 16), meta(9, 8, 2, 16),
                                    table, lengths)
    assert (out.device.type, out.shape) == ("meta", (2, 4, 3, 16))
    out = k2.bidirectional_attention(meta(1, 5, 4, 16), meta(1, 7, 2, 16), meta(1, 7, 2, 16), 7)
    assert (out.device.type, out.shape) == ("meta", (1, 5, 4, 16))
    assert (k1.launches, k2.launches, k2.bidirectional_launches, k3.launches,
            k4.launches) == before


# ------------------------- the new families' shapes: D = 80, E = 8 top 2 --
# zamba2-2.7b's shared attention runs the paged-attention core at head
# width 80 (its DP = 128 instance, 32 heads over 32: G = 1); G = 4 covers
# a grouped launch at that width. grok-1-314b gates 8 experts, top 2, over
# a 128-token chunk and a verify round of 4 slots x 5.


@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["K1", "K2", "K4", "K5"])
def test_paged_core_plain_at_head_width_80(kernel, H, Hkv, dtype):
    """K1, K2, K4 and K5's plain versions at D = 80 against the Pallas
    kernels in interpret mode (bf16 to 2e-2, float32 to F32_TOL)."""
    from repro.kernels.decode_attention import decode_attention_pallas
    rng = np.random.default_rng(80 + H)
    D, ps, nb, B, C = 80, 16, 4, 3, 5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tol = F32_TOL if dtype == "float32" else 2e-2

    def pair(*shapes):
        js = [jnp.asarray(_rand(rng, s)).astype(jdt) for s in shapes]
        return js, [_t(np.array(a, np.float32)).to(tdt) for a in js]
    P = B * nb + 2
    table = rng.permutation(P)[: B * nb].reshape(B, nb).astype(np.int32)
    if kernel == "K1":
        (q, kp, vp), targs = pair((B, H, D), (P, ps, Hkv, D), (P, ps, Hkv, D))
        lengths = np.asarray([1, 37, nb * ps], np.int32)
        want = paged_decode_attention_pallas(q, kp, vp, jnp.asarray(table),
                                             jnp.asarray(lengths), interpret=True)
        got = k1.paged_decode_attention(*targs, _t(table), _t(lengths))
    elif kernel == "K2":
        S = nb * ps
        (q, k, v), (tq, tk, tv) = pair((1, S, H, D), (1, S, Hkv, D), (1, S, Hkv, D))
        want = flash_attention_pallas(q, k, v, causal=True, bq=S // 2, bk=S // 2,
                                      interpret=True)[0]
        ident = _t(np.arange(nb, dtype=np.int32))
        got = k2.chunk_prefill_attention(tq[0], tk[0].reshape(nb, ps, Hkv, D),
                                         tv[0].reshape(nb, ps, Hkv, D), ident, 0)
    elif kernel == "K4":
        (q, kp, vp), targs = pair((B, H, C, D), (P, ps, Hkv, D), (P, ps, Hkv, D))
        starts = np.asarray([0, 29, nb * ps - C], np.int32)
        want = paged_verify_attention_pallas(q, kp, vp, jnp.asarray(table),
                                             jnp.asarray(starts), interpret=True)
        got = k4.paged_verify_attention(*targs, _t(table), _t(starts))
    else:
        S = 256
        (q, kc, vc), targs = pair((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
        want = decode_attention_pallas(q, kc, vc, 201, bk=128, interpret=True)
        got = k1.decode_attention(*targs, 201)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    assert k1.launches == k2.launches == k4.launches == k1.dense_launches == 0


@pytest.mark.parametrize("T", [128, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_gating_plain_at_grok_shapes(T, dtype):
    """K6's plain version at E = 8, k = 2 with grok's capacities (40 slots
    for a chunk of 128 tokens, 8 for a verify round of 20): weights and
    indices against the Pallas kernel in interpret mode, the slots and kept
    weights against the JAX `moe_apply`'s numbering."""
    from repro.kernels.moe_gating import moe_gating_pallas
    from repro_torch.kernels import moe_gating as k6
    from test_torch_moe import GATE_TOL, _jax_numbering
    E, k = 8, 2
    C = max(8, -(-int(np.ceil(1.25 * k * T / E)) // 8) * 8)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    logits = _t(_rand(np.random.default_rng(T), (T, E), 0.9)).to(tdt)
    f32 = logits.float().numpy()                        # bf16 -> f32 is exact
    w, idx, slot, kept = k6.moe_gating(logits, k, C)
    pw, pi = moe_gating_pallas(jnp.asarray(f32), k, bt=64 if T % 64 == 0 else T,
                               interpret=True)
    np.testing.assert_allclose(w.numpy(), np.asarray(pw), atol=GATE_TOL, rtol=GATE_TOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))
    ji, jslot, jkept, _ = _jax_numbering(f32, k, C)
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_allclose(kept.numpy(), jkept, atol=GATE_TOL, rtol=GATE_TOL)
    assert k6.launches == 0


# ------------------- K2's non-causal form and K5 at whisper's head width --
# whisper-medium's encoder self-attention and decoder cross-attention see
# every key (flash_attention_pallas(causal=False)); its decode steps'
# cross-attention is K5 over the whole cross K/V. 16 heads over 16: G = 1,
# D = 64.


@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 128, 2, 2, 64),
    (2, 256, 4, 2, 64),
    (1, 256, 8, 1, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bidirectional_plain_matches_flash_pallas(B, S, H, Hkv, D, dtype):
    """`tests/test_kernels.py`'s flash-attention shapes, causal=False: the
    plain version against the Pallas kernel in interpret mode and the jnp
    reference (bf16 to 2e-2, float32 to F32_TOL)."""
    rng = np.random.default_rng(S + H)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    q, k, v = (jnp.asarray(_rand(rng, s)).astype(jdt)
               for s in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    want = flash_attention_pallas(q, k, v, causal=False, bq=64, bk=64, interpret=True)
    want_ref = ref.flash_attention_ref(q, k, v, causal=False)
    got = k2.bidirectional_attention(*(_t(np.array(a, np.float32)).to(tdt) for a in (q, k, v)),
                                     S)
    assert got.dtype == tdt and tuple(got.shape) == (B, S, H, D)
    for w in (want, want_ref):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(w, np.float32),
                                   atol=tol, rtol=tol)
    assert k2.bidirectional_launches == 0


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,n_keys", [
    (1, 1, 100, 16, 16, 100),     # one query over every key (a decode-sized row)
    (4, 5, 100, 16, 16, 100),     # a verify round of 4 rows x 5 candidates
    (1, 37, 100, 8, 2, 100),      # a ragged chunk, GQA group 4
    (2, 64, 100, 4, 4, 77),       # a key limit below Skv
])
def test_bidirectional_plain_matches_ref_ragged(B, Sq, Skv, H, Hkv, n_keys):
    """Sq != Skv, Skv = 100 (not a multiple of the 64-key tile), D = 64:
    against `ref.flash_attention_ref(causal=False)` over the first n_keys
    keys."""
    rng = np.random.default_rng(Sq + n_keys)
    D = 64
    q, k, v = _rand(rng, (B, Sq, H, D)), _rand(rng, (B, Skv, Hkv, D)), \
        _rand(rng, (B, Skv, Hkv, D))
    want = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k[:, :n_keys]),
                                   jnp.asarray(v[:, :n_keys]), causal=False)
    got = k2.bidirectional_attention(_t(q), _t(k), _t(v), n_keys)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def test_dense_decode_plain_at_whisper_cross_shape():
    """K5's plain version as whisper's cross-attention in a decode step
    runs it: S 100, G 1 (16 heads over 16), D 64, every row's length S,
    against `ref.decode_attention_ref` and the model's `decode_attention`."""
    rng = np.random.default_rng(64)
    B, S, H, D = 4, 100, 16, 64
    q, kc, vc = _rand(rng, (B, H, D)), _rand(rng, (B, S, H, D)), _rand(rng, (B, S, H, D))
    want = ref.decode_attention_ref(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), S)
    want_model = jl.decode_attention(jnp.asarray(q).reshape(B, 1, H, 1, D), jnp.asarray(kc),
                                     jnp.asarray(vc), S).reshape(B, H, D)
    got = k1.decode_attention(_t(q), _t(kc), _t(vc), S)
    for w in (want, want_model):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=F32_TOL, rtol=F32_TOL)
    assert k1.dense_launches == 0
