"""K2's non-causal form on its Hopper kernel (`csrc/bidirectional_attention_sm90.cu`):
the route between it and the paged-attention core at whisper-medium's
launch shapes, and a torch walk of the kernel's
arithmetic (its tile constants from the wrapper module; 128-key tiles, the
last one masked at n_keys, zero rows past Sq and Skv as TMA fills them, an
fp32 online softmax in exp2, the unnormalised P rounded to bf16 once)
against the plain version and the JAX package's reference. The CUDA
kernel itself is held against the plain version on the card by
`chip_smoke.py`."""
import math

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as k2  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 2e-2     # chip_smoke.TOL["bfloat16"], tests/test_kernels.py's allclose form
# whisper-medium's launches of the non-causal form (chip_smoke's whisper phase:
# chunks of 128, verify rounds of 4 slots x (spec_k 4 + 1) candidates)
WHISPER = get_config("whisper-medium")


def _whisper(B, Sq, dtype=torch.bfloat16, D=None):
    return (dtype, B, Sq, WHISPER.n_heads, WHISPER.n_kv_heads, D or WHISPER.resolved_head_dim)


@pytest.mark.parametrize("args,want", [
    (_whisper(1, WHISPER.encoder_seq), "sm90"),                    # the encoder
    (_whisper(1, 858), "sm90"),                                     # a slab prompt's cross-attn
    (_whisper(1, 128), "core"),                                     # a chunk's cross-attention
    (_whisper(4, 5), "core"),                                       # a verify round's
    (_whisper(1, WHISPER.encoder_seq, torch.float32), "core"),     # the reference phase's float32
    (_whisper(1, WHISPER.encoder_seq, D=80), "core"),              # another head width
    ((torch.bfloat16, 1, k2.SM90_MIN_ROWS, 16, 16, 64), "sm90"),   # the threshold, G 1
    ((torch.bfloat16, 1, k2.SM90_MIN_ROWS - 1, 16, 16, 64), "core"),
    ((torch.bfloat16, 2, k2.SM90_MIN_ROWS, 16, 4, 64), "sm90"),    # G 4: Sq rows a head,
    ((torch.bfloat16, 2, k2.SM90_MIN_ROWS - 1, 16, 4, 64), "core"),  # not G x Sq
])
def test_route_by_shape(args, want):
    assert k2.bidirectional_route(*args) == want


def _walk(q, k, v, n_keys, round_p):
    """The kernel's arithmetic in torch, one (batch, query head, query tile)
    at a time, on q's dtype rounded to float32: scores in float32, masked
    past n_keys in the last 128-key tile, running max in the exp2 domain,
    the old sums rescaled by exp2(m_old - m_new), P rounded to bf16 when
    round_p, O / l at the end, in q's dtype."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    q_tile, kt_n = k2.SM90_Q_TILE, k2.SM90_KEY_TILE
    n_tiles = -(-n_keys // kt_n)
    pad = n_tiles * kt_n
    kz = torch.zeros((B, pad, Hkv, D))
    vz = torch.zeros((B, pad, Hkv, D))
    kz[:, :min(pad, Skv)] = k[:, :pad].float()          # TMA's zero rows past Skv
    vz[:, :min(pad, Skv)] = v[:, :pad].float()
    scale_log2 = math.log2(math.e) / math.sqrt(D)
    out = torch.empty((B, Sq, H, D))
    for b in range(B):
        for h in range(H):
            for q0 in range(0, Sq, q_tile):
                rows = min(q_tile, Sq - q0)
                qt = torch.zeros((q_tile, D))                # and past Sq
                qt[:rows] = q[b, q0:q0 + rows, h].float()
                m = torch.full((q_tile,), -math.inf)
                lsum = torch.zeros(q_tile)
                o = torch.zeros((q_tile, D))
                for i in range(n_tiles):
                    keys = slice(i * kt_n, (i + 1) * kt_n)
                    s = qt @ kz[b, keys, h // G].T
                    s[:, torch.arange(i * kt_n, (i + 1) * kt_n) >= n_keys] = -math.inf
                    m_new = torch.maximum(m, s.max(1).values * scale_log2)
                    c = torch.exp2(m - m_new)
                    p = torch.exp2(s * scale_log2 - m_new[:, None])
                    lsum = lsum * c + p.sum(1)
                    if round_p:
                        p = p.bfloat16().float()
                    o = o * c[:, None] + p @ vz[b, keys, h // G]
                    m = m_new
                out[b, q0:q0 + rows, h] = (o / lsum[:, None])[:rows]
    return out.to(q.dtype)


# ragged on every axis, (B, Sq, Skv, n_keys) at D 64: Sq 200 (a partial
# second query tile), Skv 300 (a partial third key tile), n_keys 257 (the
# limit inside a tile), B 2; Sq 385 (a second tile and one row) over a
# partial key tile with the limit inside the first; Sq 257 (a tile, a
# warpgroup and a row) over whisper's 1,500 keys with chip_smoke's limit
SHAPES = {"ragged": (2, 200, 300, 257), "one_key_tile": (1, 385, 129, 127),
          "whisper_keys": (1, 257, 1500, 1463)}
D = 64


def _inputs(shape, Hkv, dtype=torch.float32, seed=24):
    rng = np.random.default_rng(seed + Hkv)
    B, Sq, Skv, n = SHAPES[shape]
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
               for s in ((B, Sq, 4, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    return q, k, v, n


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("Hkv", [4, 1])
def test_walk_float32_matches_plain_and_ref(Hkv, shape):
    """Without the rounding of P the walk is the same function as the plain
    version and the JAX reference over the first n_keys keys, to float32's
    summation order (F32_TOL)."""
    q, k, v, n = _inputs(shape, Hkv)
    got = _walk(q, k, v, n, round_p=False)
    np.testing.assert_allclose(got.numpy(), k2.bidirectional_attention_plain(q, k, v, n).numpy(),
                               atol=F32_TOL, rtol=F32_TOL)
    want = ref.flash_attention_ref(jnp.asarray(q.numpy()), jnp.asarray(k[:, :n].numpy()),
                                   jnp.asarray(v[:, :n].numpy()), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("Hkv", [4, 1])
def test_walk_bf16_p_within_its_bound(Hkv, shape):
    """The kernel's one rounding, P to bf16 before P V, on float32 inputs:
    each probability moves by at most 2^-9 of itself and the denominator is
    summed unrounded, so an output moves by at most 2^-9 x max|v| (+
    F32_TOL) from the plain version and from the JAX reference; and it does
    move (the rounding is real)."""
    q, k, v, n = _inputs(shape, Hkv)
    got = _walk(q, k, v, n, round_p=True)
    bound = 2.0 ** -9 * float(v[:, :n].abs().max()) + F32_TOL
    plain = k2.bidirectional_attention_plain(q, k, v, n)
    want = ref.flash_attention_ref(jnp.asarray(q.numpy()), jnp.asarray(k[:, :n].numpy()),
                                   jnp.asarray(v[:, :n].numpy()), causal=False)
    for w in (plain.numpy(), np.asarray(want)):
        err = np.abs(got.numpy() - w).max()
        assert err <= bound, (err, bound)
    assert float((got - plain).abs().max()) > F32_TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("Hkv", [4, 1])
def test_walk_bf16_matches_plain_bf16(Hkv, shape):
    """The walk on bf16 inputs, output in bf16, against the plain version on
    the same bf16 inputs: within BF16_TOL in the allclose form of
    `tests/test_kernels.py` (atol = rtol), the check the card makes."""
    q, k, v, n = _inputs(shape, Hkv, torch.bfloat16)
    got = _walk(q, k, v, n, round_p=True)
    assert got.dtype == torch.bfloat16
    want = k2.bidirectional_attention_plain(q, k, v, n)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=BF16_TOL, rtol=BF16_TOL)


def test_cpu_tensors_take_the_plain_version():
    """A bf16 launch at the encoder's route shape on the CPU is the plain
    version and counts no launch of either kernel."""
    q, k, v, n = _inputs("ragged", 4, torch.bfloat16)
    q = q.repeat(1, 2, 1, 1)                     # Sq = 400 >= SM90_MIN_ROWS
    assert k2.bidirectional_route(q.dtype, q.shape[0], q.shape[1], 4, 4, 64) == "sm90"
    before = (k2.bidirectional_launches, k2.bidirectional_sm90_launches)
    got = k2.bidirectional_attention(q, k, v, n)
    assert torch.equal(got, k2.bidirectional_attention_plain(q, k, v, n))
    assert (k2.bidirectional_launches, k2.bidirectional_sm90_launches) == before
