"""Plain PyTorch versions of the port's kernels (K1 paged decode attention,
K2 paged chunk-prefill attention, K3 L2 top-k) against the JAX package's
Pallas kernels in interpret mode and its jnp references, on the same
numpy inputs. The CUDA kernels themselves are held against these plain
versions on the card by `chip_smoke.py`."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    paged_decode_attention_pallas, paged_decode_attention_ref)
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.topk_l2 import topk_l2_pallas  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.kernels import decode_attention as k1  # noqa: E402
from repro_torch.kernels import flash_attention as k2  # noqa: E402
from repro_torch.kernels import topk_l2 as k3  # noqa: E402

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


def test_no_silent_cpu_fallback():
    """Entry points default to the CUDA device and raise without one; a
    wrapper given a tensor that is neither on the CPU nor on CUDA raises
    instead of running the plain version."""
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    meta = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError):
        k3.topk_l2(meta, meta, 2)
    with pytest.raises(ValueError):
        k1.paged_decode_attention(torch.empty((1, 2, 8), device="meta"),
                                  None, None, None, None)
