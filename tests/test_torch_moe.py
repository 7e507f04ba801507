"""MoE with MLA attention on the port against the JAX package: K6's plain
version against `moe_gating_pallas` in interpret mode and the oracle
`ref.moe_gating_ref` (index order included, ties and bf16-rounded logits);
`moe_capacity` and `moe_apply` with assignments dropped at capacity; the
MLA functions, the paged forms held against the JAX slab forms on the same
context; the moe-family model functions (whole-prompt prefill, chunked
prefill, decode and verify on the page pool, with the JAX engine's gather
and scatter on the reference side), and the bridge, on bridged SMOKE
deepseek-v2-lite-16b weights."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import lm_data  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.moe_gating import moe_gating_pallas  # noqa: E402
from repro.models import cache_ops as jops  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import param_count as jax_param_count  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import prefill_chunk as jax_prefill_chunk  # noqa: E402
from repro.models import verify_chunk as jax_verify_chunk  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import moe_gating as k6  # noqa: E402
from repro_torch.models import (decode_step, decode_step_slab,  # noqa: E402
                                init_decode_cache, init_params, param_count, prefill,
                                prefill_chunk, verify_chunk, verify_chunk_slab)
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models.cache_ops import PAGE_SINK  # noqa: E402
from repro_torch.serving.engine import _pow2_at_least  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
GATE_TOL = 1e-5       # K6's plain version against Pallas / the oracle, as
                      # tests/test_kernels.py holds the Pallas kernel
F32_TOL = 2e-5        # model functions at SMOKE size, float32
PS, MAX_LEN = 8, 64


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _close(got, want, tol=F32_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    tcfg = get_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    tparams = params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, jparams, tcfg, tparams, tree


def _layer(tree, stack, i):
    return jax.tree.map(lambda a: jnp.asarray(a[i]), tree[stack])


# ------------------------------------------------------------ K6 gating ---


def _gating_all(logits, k):
    """(plain, Pallas in interpret mode, oracle) on the same logits."""
    tw, ti = k6.moe_gating(_t(logits), k)
    pw, pi = moe_gating_pallas(jnp.asarray(logits), k, bt=64, interpret=True)
    rw, ri = ref.moe_gating_ref(jnp.asarray(logits), k)
    return (tw.numpy(), ti.numpy()), (np.asarray(pw), np.asarray(pi)), \
        (np.asarray(rw), np.asarray(ri))


@pytest.mark.parametrize("T,E,k", [(100, 8, 2), (256, 64, 6), (17, 4, 2)])
def test_moe_gating_plain_matches_pallas_and_oracle(T, E, k):
    """The cases of `tests/test_kernels.py::test_moe_gating`: weights to
    1e-5, and the indices equal in order, not only as sets."""
    logits = (np.random.default_rng(T).standard_normal((T, E)) * 2.0).astype(np.float32)
    (tw, ti), (pw, pi), (rw, ri) = _gating_all(logits, k)
    assert ti.dtype == np.int32 and ti.shape == (T, k)
    for w, i in ((pw, pi), (rw, ri)):
        np.testing.assert_allclose(tw, w, atol=GATE_TOL, rtol=GATE_TOL)
        np.testing.assert_array_equal(ti, i)
    assert k6.launches == 0                 # CPU tensors take the plain version


@pytest.mark.parametrize("T,E,k", [(5, 8, 2), (3, 64, 6), (2, 160, 7)])
def test_moe_gating_ties_take_the_lowest_index(T, E, k):
    """Equal logits give equal probabilities: indices 0..k-1 in order and
    weights 1/k, as `lax.top_k` and the Pallas kernel's arg-max give."""
    logits = np.full((T, E), 0.37, np.float32)
    (tw, ti), (pw, pi), (rw, ri) = _gating_all(logits, k)
    np.testing.assert_array_equal(ti, np.tile(np.arange(k, dtype=np.int32), (T, 1)))
    np.testing.assert_allclose(tw, np.full((T, k), 1.0 / k), atol=1e-7, rtol=1e-6)
    for i in (pi, ri):
        np.testing.assert_array_equal(ti, i)


def test_moe_gating_bf16_rounded_logits():
    """Router logits formed in bf16 (std ~0.9 at full width, a bf16 ulp
    ~0.008) tie often among 64 experts: the plain version keeps the
    oracle's and the Pallas kernel's order on every tie."""
    rng = np.random.default_rng(7)
    logits = torch.from_numpy(rng.standard_normal((512, 64)).astype(np.float32) * 0.9)
    logits = logits.to(torch.bfloat16).float().numpy()
    (tw, ti), (pw, pi), (rw, ri) = _gating_all(logits, 6)
    for w, i in ((pw, pi), (rw, ri)):
        np.testing.assert_allclose(tw, w, atol=GATE_TOL, rtol=GATE_TOL)
        np.testing.assert_array_equal(ti, i)
    picked = np.take_along_axis(logits, ti.astype(np.int64), 1)
    ties = (np.diff(picked, axis=1) == 0).sum()
    assert ties > 10                         # the order of equal logits was tested


def test_moe_gating_wrapper_rejects_what_the_kernel_does_not_take():
    """k outside 1..E, more than 256 experts, a tensor not (T, E), or a
    capacity below 1; a meta tensor (the dry run's) takes the plain
    version on the meta device, with no launch."""
    for shape, k in (((4, 8), 9), ((4, 8), 0), ((4, 300), 2), ((4,), 1)):
        with pytest.raises(ValueError):
            k6.moe_gating(torch.zeros(shape), k)
    with pytest.raises(ValueError, match="capacity"):
        k6.moe_gating(torch.zeros((4, 8)), 2, 0)
    before = k6.launches
    w, idx = k6.moe_gating(torch.zeros((4, 8), device="meta"), 2)
    assert (w.device.type, w.shape, idx.shape) == ("meta", (4, 2), (4, 2))
    assert k6.launches == before


def _jax_numbering(logits, k, C):
    """The JAX `moe_apply`'s gating and dispatch numbering, its lines
    (src/repro/models/layers.py:643-654) on the same logits: (top_i, slot,
    kept weight flat_w * keep, keep)."""
    lg = jnp.asarray(logits).astype(jnp.float32)
    E = lg.shape[1]
    probs = jax.nn.softmax(lg, axis=-1)
    top_w, top_i = jax.lax.top_k(probs, k)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    flat_e, flat_w = top_i.reshape(-1), top_w.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1, flat_e[:, None], axis=1)[:, 0]
    keep = pos < C
    slot = jnp.where(keep, flat_e * C + pos, E * C)
    return tuple(np.asarray(a) for a in (top_i, slot, flat_w * keep, keep))


def _kernel_numbering(idx: np.ndarray, E: int, C: int) -> np.ndarray:
    """K6's numbering as `csrc/moe_gating.cu` splits it, in numpy: the
    plan's blocks of `per` rows, each block's assignments in contiguous
    warp shares walked 32 at a time (a group of equal experts in a 32 adds
    its size; an assignment's rank in it is the equal ones on lower lanes),
    the per-warp counts scanned over warps, the block totals over blocks."""
    T, k = idx.shape
    plan = k6.gating_plan(T)
    assert 1 <= plan.cs <= k6.MAX_CLUSTER and plan.cs * plan.per >= T
    nwarps = plan.threads // 32
    flat = idx.reshape(-1).astype(np.int64)
    slot = np.full(T * k, -1, np.int64)
    btot = np.zeros((plan.cs, E), np.int64)
    walks = []
    for b in range(plan.cs):
        lo, hi = min(T, b * plan.per), min(T, (b + 1) * plan.per)
        A = (hi - lo) * k
        share = -(-A // nwarps)
        wcnt = np.zeros((nwarps, E), np.int64)
        for w in range(nwarps):
            a_lo = min(A, w * share)
            a_hi = min(A, a_lo + share)
            for a0 in range(a_lo, a_hi, 32):
                np.add.at(wcnt[w], flat[lo * k + a0: lo * k + min(a0 + 32, a_hi)], 1)
            walks.append((b, w, lo * k + a_lo, lo * k + a_hi))
        base = np.cumsum(wcnt, 0) - wcnt                 # exclusive, over warps
        btot[b] = wcnt.sum(0)
        walks[-nwarps:] = [(b, w, g_lo, g_hi, base[w].copy())
                           for (b, w, g_lo, g_hi) in walks[-nwarps:]]
    cbase = np.cumsum(btot, 0) - btot                    # exclusive, over blocks
    for b, _w, g_lo, g_hi, base in walks:
        for a0 in range(g_lo, g_hi, 32):
            chunk = flat[a0: min(a0 + 32, g_hi)]
            for lane, e in enumerate(chunk):
                pos = cbase[b, e] + base[e] + (chunk[:lane] == e).sum()
                slot[a0 + lane] = e * C + pos if pos < C else E * C
            np.add.at(base, chunk, 1)
    return slot


@pytest.mark.parametrize("case,T,E,k,C", [
    ("drops", 64, 8, 2, 8),              # 128 assignments for 64 slots
    ("one expert", 50, 16, 2, 8),        # every token's first pick is expert 3
    ("T=1", 1, 64, 6, 8),
    ("E=40", 37, 40, 3, 8),              # E not a multiple of 32
    ("k=1", 100, 8, 1, 32),
    ("k=E", 20, 8, 8, 24),
    ("bf16 chunk", 128, 64, 6, 16),      # deepseek-v2-lite-16b's chunk launch
    ("bf16 verify", 20, 64, 6, 8),       # and its verify round
    ("many chunks", 2000, 64, 6, 240),   # 47 assignments a warp: two walks of 32
])
def test_moe_gating_numbering_matches_jax(case, T, E, k, C):
    """The fused outputs of K6's plain version -- indices, slots and kept
    weights -- against the JAX `moe_apply`'s top_k, slot and flat_w * keep
    on the same logits; and the kernel's split of the numbering over
    blocks, warps and 32s (numpy) against the plain slots."""
    rng = np.random.default_rng(T * E + k)
    logits = (rng.standard_normal((T, E)) * 0.9).astype(np.float32)
    if case == "one expert":
        logits[:, 3] += 10.0
    t_logits = _t(logits, torch.bfloat16) if case.startswith("bf16") else _t(logits)
    logits = t_logits.float().numpy()                   # bf16 -> f32 is exact
    w, idx, slot, kept = k6.moe_gating(t_logits, k, C)
    assert slot.dtype == torch.int64 and kept.dtype == torch.float32
    assert slot.shape == kept.shape == (T * k,)
    ji, jslot, jkept, jkeep = _jax_numbering(logits, k, C)
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_array_equal(slot.numpy(), jslot)
    np.testing.assert_allclose(kept.numpy(), jkept, atol=GATE_TOL, rtol=GATE_TOL)
    assert torch.equal(kept, w.reshape(-1) * torch.from_numpy(jkeep.copy()))
    np.testing.assert_array_equal(_kernel_numbering(idx.numpy(), E, C), slot.numpy())
    if case in ("drops", "one expert"):
        assert (~jkeep).sum() > 0
    assert k6.launches == 0


# ------------------------------------------------------------------ MoE ---


def test_moe_capacity_matches_jax():
    """C from the T of the call: 8 at T <= 32, 16 at T = 128 and 120 at
    T = 1024 for deepseek-v2-lite-16b (capacity factor 1.25, k = 6, E = 64)."""
    tcfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    for T in (1, 4, 20, 32, 33, 128, 500, 1024):
        assert tL.moe_capacity(tcfg, T) == jL.moe_capacity(jcfg, T)
    assert [tL.moe_capacity(tcfg, T) for T in (4, 20, 32, 128, 1024)] == [8, 8, 8, 16, 120]


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_moe_apply_matches_jax(weights, cf):
    """moe_apply at SMOKE widths in float32 on 64 tokens: at the shipped
    capacity factor, and at 0.25, where 128 assignments over 8 experts
    meet 8 slots each and many are dropped (asserted)."""
    jcfg, _, tcfg, tparams, tree = weights
    jcfg, tcfg = jcfg.replace(capacity_factor=cf), tcfg.replace(capacity_factor=cf)
    x = np.random.default_rng(3).standard_normal((4, 16, tcfg.d_model)).astype(np.float32)
    jp, tp = _layer(tree, "layers", 0)["moe"], tparams["layers"][0]["moe"]
    want = jL.moe_apply(jcfg, jp, jnp.asarray(x))
    got = tL.moe_apply(tcfg, tp, _t(x))
    _close(got.numpy(), want)
    _, idx = k6.moe_gating_plain(_t(x).reshape(64, -1) @ tp["router"], tcfg.moe_top_k)
    counts = np.bincount(idx.numpy().ravel(), minlength=tcfg.n_experts)
    dropped = np.maximum(counts - tL.moe_capacity(tcfg, 64), 0).sum()
    assert (dropped > 0) == (cf < 1)


# ------------------------------------------------------------------ MLA ---


def _mla(tree, tparams, i=0):
    return _layer(tree, "layers", i)["attn"], tparams["layers"][i]["attn"]


def test_mla_project_and_full_sequence_match_jax(weights):
    jcfg, _, tcfg, tparams, tree = weights
    jp, tp = _mla(tree, tparams)
    x = np.random.default_rng(4).standard_normal((2, 11, tcfg.d_model)).astype(np.float32)
    positions = np.arange(11)[None] + np.array([[0], [5]])
    for a, b in zip(tL.mla_project(tcfg, tp, _t(x), torch.as_tensor(positions)),
                    jL.mla_project(jcfg, jp, jnp.asarray(x), jnp.asarray(positions))):
        _close(a.numpy(), b)
    got, c_kv, k_rope = tL.mla_apply(tcfg, tp, _t(x), positions=torch.arange(11)[None])
    want, (jc, jk) = jL.mla_apply(jcfg, jp, jnp.asarray(x), positions=jnp.arange(11)[None])
    _close(got.numpy(), want)
    _close(c_kv.numpy(), jc)
    _close(k_rope.numpy(), jk)


def _paged(caches, rng):
    """(B, S, w) slab contexts laid into pools of shuffled pages behind a
    sink page full of noise, one page table for all: ([pool (P, PS, w)],
    tables (B, S / PS))."""
    B, S, _ = caches[0].shape
    nb = S // PS
    ids = rng.permutation(B * nb) + 1
    pools = []
    for c in caches:
        pool = rng.standard_normal((B * nb + 1, PS, c.shape[2])).astype(np.float32)
        pool[ids] = c.reshape(B * nb, PS, c.shape[2])
        pools.append(_t(pool))
    return pools, torch.as_tensor(ids.reshape(B, nb).astype(np.int32))


def _context(tcfg, rng, B, S=32):
    return (rng.standard_normal((B, S, tcfg.kv_lora_rank)).astype(np.float32),
            rng.standard_normal((B, S, tcfg.qk_rope_dim)).astype(np.float32))


def test_mla_decode_matches_jax_slab_and_paged(weights):
    """Absorbed decode at per-row positions: the port's slab form and its
    paged form (gathered views, the block holding pos written back) give
    the JAX slab form's output and write the same compressed KV."""
    jcfg, _, tcfg, tparams, tree = weights
    jp, tp = _mla(tree, tparams)
    rng = np.random.default_rng(5)
    ckv, kr = _context(tcfg, rng, 3)
    x = rng.standard_normal((3, 1, tcfg.d_model)).astype(np.float32)
    pos = np.array([4, 17, 31], np.int32)
    want, (jckv, jkr) = jL.mla_decode_apply(jcfg, jp, jnp.asarray(x), pos=jnp.asarray(pos),
                                            ckv_cache=jnp.asarray(ckv), krope_cache=jnp.asarray(kr))
    tc, tk = _t(ckv), _t(kr)
    got = tL.mla_decode_apply_slab(tcfg, tp, _t(x), pos=torch.as_tensor(pos),
                                   ckv_cache=tc, krope_cache=tk)
    _close(got.numpy(), want)
    _close(tc.numpy(), jckv)
    _close(tk.numpy(), jkr)
    (pc, pk), table = _paged((ckv, kr), rng)
    wp = table.gather(1, torch.as_tensor(pos // PS, dtype=torch.int64)[:, None])[:, 0]
    got = tL.mla_decode_apply(tcfg, tp, _t(x), pos=torch.as_tensor(pos), ckv_pool=pc,
                              krope_pool=pk, table=table, write_pages=wp)
    _close(got.numpy(), want)
    _close(tL.page_view(pc, table).numpy(), jckv)
    _close(tL.page_view(pk, table).numpy(), jkr)


@pytest.mark.parametrize("start", [0, 9, "rows"])
def test_mla_chunk_matches_jax_slab_and_paged(weights, start):
    """Chunked MLA: a shared start (prefill chunks) and per-row starts
    (verify rounds, a row near the end dropping its last candidates), on
    the slab and on the pool, against the JAX slab form."""
    jcfg, _, tcfg, tparams, tree = weights
    jp, tp = _mla(tree, tparams)
    rng = np.random.default_rng(6)
    B, C = (1, 8) if start != "rows" else (3, 5)
    ckv, kr = _context(tcfg, rng, B)
    x = rng.standard_normal((B, C, tcfg.d_model)).astype(np.float32)
    st = np.array([2, 13, 29], np.int32) if start == "rows" else start
    want, (jckv, jkr) = jL.mla_chunk_apply(jcfg, jp, jnp.asarray(x), start=jnp.asarray(st),
                                           ckv_cache=jnp.asarray(ckv), krope_cache=jnp.asarray(kr))
    tst = torch.as_tensor(st) if start == "rows" else st
    tc, tk = _t(ckv), _t(kr)
    got = tL.mla_chunk_apply_slab(tcfg, tp, _t(x), start=tst, ckv_cache=tc, krope_cache=tk)
    _close(got.numpy(), want)
    _close(tc.numpy(), jckv)
    _close(tk.numpy(), jkr)
    (pc, pk), table = _paged((ckv, kr), rng)
    if start == "rows":
        nb = (C + PS - 2) // PS + 1
        b0s = torch.as_tensor(np.minimum(st // PS, table.shape[1] - nb))
        got = tL.mla_verify_apply(tcfg, tp, _t(x), pos=tst, ckv_pool=pc, krope_pool=pk,
                                  table=table, block0s=b0s)
    else:
        got = tL.mla_chunk_apply(tcfg, tp, _t(x), start=st, ckv_pool=pc, krope_pool=pk,
                                 ctx_ids=table[0])
    _close(got.numpy(), want)
    _close(tL.page_view(pc, table).numpy(), jckv)
    _close(tL.page_view(pk, table).numpy(), jkr)


def test_write_view_blocks_matches_jax_scatter():
    """Blocks of gathered views back into the pool, duplicates (the sink)
    last-wins, as `cache_ops.scatter_chunk_pages_rows` leaves them."""
    rng = np.random.default_rng(8)
    pool = rng.standard_normal((1, 9, PS, 3)).astype(np.float32)
    view = rng.standard_normal((1, 3, 4 * PS, 3)).astype(np.float32)
    wtabs = np.array([[4, 5], [0, 0], [7, 0]], np.int32)
    b0s = np.array([1, 0, 2], np.int32)
    want = jops.scatter_chunk_pages_rows({"k": jnp.asarray(pool)}, {"k": jnp.asarray(view)},
                                         jnp.asarray(wtabs), jnp.asarray(b0s), PS, 2)["k"]
    got = _t(pool[0])
    blocks = torch.as_tensor(b0s)[:, None].long() + torch.arange(2)[None]
    tL.write_view_blocks(got, _t(view[0]), blocks, torch.as_tensor(wtabs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[0])
    np.testing.assert_array_equal(got[PAGE_SINK].numpy(), view[0, 2, 3 * PS:])


# -------------------------------------------------------- model functions --


def _pools(tcfg, rng, n_pages):
    """ckv/krope pools (L, P, PS, w) full of noise, the sink included."""
    L = tcfg.num_layers
    return {"ckv": rng.standard_normal((L, n_pages, PS, tcfg.kv_lora_rank)).astype(np.float32),
            "krope": rng.standard_normal((L, n_pages, PS, tcfg.qk_rope_dim)).astype(np.float32)}


def test_paged_model_functions_match_jax_engine_form(weights):
    """prefill_chunk, decode_step and verify_chunk on the page pool against
    the JAX model functions run as the JAX engine runs them (gather the
    page views, run the slab form, scatter the dirtied pages back): logits
    and every page, the sink included, after each call. Row 1 is a dead
    slot (all-sink table, its position past the view)."""
    jcfg, jparams, tcfg, tparams, _ = weights
    rng = np.random.default_rng(9)
    pnp = _pools(tcfg, rng, 12)
    jpools = {k: jnp.asarray(v) for k, v in pnp.items()}
    tpools = {k: _t(v) for k, v in pnp.items()}
    pages = [5, 2, 9, 7]                                   # 32 positions

    def same_pools(msg):
        for k in pnp:
            _close(tpools[k].numpy(), jpools[k], msg=f"{msg}: {k}")

    # two chunks of 12, the second padded past the sequence's pages
    cs, lpos, prompt = 12, 0, [int(t) for t in rng.integers(0, 256, size=19)]
    for i in range(0, len(prompt), cs):
        real = prompt[i:i + cs]
        chunk = real + [0] * (cs - len(real))
        nb = (cs + PS - 2) // PS + 1
        n_ctx = _pow2_at_least(max(-(-(lpos + cs) // PS), nb))
        ctx = [pages[b] if b < 3 else PAGE_SINK for b in range(n_ctx)]   # 3 pages allocated
        b0 = min(lpos // PS, n_ctx - nb)
        dense = {"pos": jnp.asarray(lpos, jnp.int32),
                 **jops.gather_page_views(jpools, jnp.asarray([ctx], jnp.int32))}
        jl, new = jax_prefill_chunk(jcfg, jparams, {"tokens": jnp.asarray([chunk])}, dense,
                                    length=jnp.asarray(len(real)))
        jpools = jops.scatter_chunk_pages(jpools, new, jnp.asarray(ctx[b0:b0 + nb]), b0, PS, nb)
        tl = prefill_chunk(tcfg, tparams, torch.as_tensor([chunk]), lpos, len(real), tpools,
                           torch.as_tensor(np.asarray(ctx, np.int32)))
        _close(tl.numpy(), jl, msg="chunk logits")
        same_pools("chunk")
        lpos += len(real)
    # decode: row 0 live at lpos, row 1 dead past its view
    table = np.array([[5, 2, 9, 7], [PAGE_SINK] * 4], np.int32)
    pos = np.array([lpos, 40], np.int32)
    for t in (11, 12, 13):
        wids = np.array([table[0, pos[0] // PS], PAGE_SINK], np.int32)
        dense = {"pos": jnp.asarray(pos), **jops.gather_page_views(jpools, jnp.asarray(table))}
        jl, new = jax_decode_step(jcfg, jparams, jnp.asarray([[t], [3]]), dense)
        jpools = jops.scatter_token_pages(jpools, new, jnp.asarray(wids),
                                          jnp.asarray((pos // PS) * PS), PS)
        tl = decode_step(tcfg, tparams, torch.as_tensor([[t], [3]]), torch.as_tensor(pos),
                         tpools, torch.as_tensor(table), torch.as_tensor(wids))
        _close(tl.numpy(), jl, msg="decode logits")
        same_pools("decode")
        pos = pos + 1
    # verify: C = 5 candidates per row, row 1 dead (block 0, all sink)
    C = 5
    nb = (C + PS - 2) // PS + 1
    b0s = np.array([min(pos[0] // PS, table.shape[1] - nb), 0], np.int32)
    wtabs = np.stack([table[0, b0s[0]:b0s[0] + nb], [PAGE_SINK] * nb]).astype(np.int32)
    toks = np.array([[4, 8, 15, 16, 23], [0] * C])
    dense = {"pos": jnp.asarray(pos), **jops.gather_page_views(jpools, jnp.asarray(table))}
    jl, new, _ = jax_verify_chunk(jcfg, jparams, {"tokens": jnp.asarray(toks)}, dense)
    jpools = jops.scatter_chunk_pages_rows(jpools, new, jnp.asarray(wtabs), jnp.asarray(b0s),
                                           PS, nb)
    tl = verify_chunk(tcfg, tparams, torch.as_tensor(toks), torch.as_tensor(pos), tpools,
                      torch.as_tensor(table), None, None, block0s=torch.as_tensor(b0s))
    _close(tl[:1].numpy(), jl[:1], msg="verify logits")
    _close(tl.numpy(), jl, msg="verify logits, dead row")
    same_pools("verify")


def test_slab_model_functions_match_jax(weights):
    """Bucketed whole-prompt prefill (non-absorbed MLA, the MoE routing
    over pad positions too), then decode steps and a verify round at
    per-row positions on the slab, against the JAX slab functions."""
    jcfg, jparams, tcfg, tparams, _ = weights
    rng = np.random.default_rng(10)
    toks = rng.integers(0, 256, size=(2, 16))
    jl, jc = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)}, MAX_LEN,
                         length=jnp.asarray(13))
    tl, tc = prefill(tcfg, tparams, torch.as_tensor(toks), MAX_LEN, length=13)
    _close(tl.numpy(), jl)
    assert int(tc["pos"]) == int(jc["pos"]) == 13
    assert tc.keys() == jc.keys() == {"pos", "ckv", "krope"}
    for k in ("ckv", "krope"):
        _close(tc[k].numpy(), jc[k], msg=k)
    jc = {**jc, "pos": jnp.asarray([13, 13], jnp.int32)}
    tc["pos"] = torch.as_tensor([13, 13], dtype=torch.int32)
    for t in (5, 6):
        jl, jc = jax_decode_step(jcfg, jparams, jnp.asarray([[t], [t + 1]]), jc)
        tl, tc = decode_step_slab(tcfg, tparams, torch.as_tensor([[t], [t + 1]]), tc)
        _close(tl.numpy(), jl)
    cand = np.array([[1, 2, 3, 4, 5], [9, 8, 7, 0, 0]])
    jl, jc, _ = jax_verify_chunk(jcfg, jparams, {"tokens": jnp.asarray(cand)}, jc)
    tl, tc = verify_chunk_slab(tcfg, tparams, torch.as_tensor(cand), tc)
    _close(tl.numpy(), jl)
    for k in ("ckv", "krope"):
        _close(tc[k].numpy(), jc[k], msg=k)
    assert tc["pos"].tolist() == [20, 20]


# --------------------------------------------------------- params, bridge --


def test_bridge_and_init_match_the_jax_tree(weights):
    """`params_from_numpy` turns both stacked trees into per-layer lists
    with the JAX leaves; `init_params` draws the same names and shapes;
    `param_count` is the JAX package's, at SMOKE and at full width
    (15,706,484,224, counted on the meta device)."""
    jcfg, jparams, tcfg, tparams, tree = weights
    assert len(tparams["dense_layers"]) == tcfg.first_dense_layers == 1
    assert len(tparams["layers"]) == tcfg.num_layers - 1
    for stack in ("dense_layers", "layers"):
        for i, lp in enumerate(tparams[stack]):
            want = jax.tree.map(lambda a: a[i], tree[stack])
            assert jax.tree.structure(lp) == jax.tree.structure(want)
            for a, b in zip(jax.tree.leaves(lp), jax.tree.leaves(want)):
                np.testing.assert_array_equal(a.numpy(), b)
    mine = init_params(tcfg, torch.Generator().manual_seed(1), device="cpu")
    for a, b in ((mine, tparams), (mine["layers"][0], tparams["layers"][0]),
                 (mine["dense_layers"][0], tparams["dense_layers"][0])):
        assert jax.tree.structure({k: 0 for k in a}) == jax.tree.structure({k: 0 for k in b})
    assert [x.shape for x in jax.tree.leaves(mine)] == \
        [x.shape for x in jax.tree.leaves(tparams)]
    assert abs(float(mine["layers"][0]["moe"]["w_up"].std()) - 0.02) < 0.004
    assert param_count(tparams) == param_count(mine) == jax_param_count(jparams)
    full = init_params(get_config(ARCH), device="meta")
    assert param_count(full) == 15_706_484_224
    cache = init_decode_cache(tcfg, 2, MAX_LEN, device="cpu")
    assert cache["ckv"].shape == (tcfg.num_layers, 2, MAX_LEN, tcfg.kv_lora_rank)
    assert cache["krope"].shape == (tcfg.num_layers, 2, MAX_LEN, tcfg.qk_rope_dim)
