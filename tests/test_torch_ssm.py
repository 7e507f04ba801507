"""Mamba1 on the port against the JAX package: K7's plain version against
`ssm_scan_pallas` in interpret mode and the jnp scans (`mamba1_scan_ref`
from a carried state, `mamba1_scan_states`); the Mamba1 block functions
(conv, decode step, chunk with and without a true length, chunk with
states); and the ssm-family model functions (whole-prompt prefill, chunked
prefill, decode, verify checkpoints and the rollback contract), the cache
surgery and the bridge, on bridged SMOKE falcon-mamba-7b weights."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import lm_data  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_pallas  # noqa: E402
from repro.models import cache_ops as jops  # noqa: E402
from repro.models import decode_step as jax_decode_step  # noqa: E402
from repro.models import init_decode_cache as jax_init_decode_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models import prefill_chunk as jax_prefill_chunk  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import verify_chunk as jax_verify_chunk  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ssm_scan as k7  # noqa: E402
from repro_torch.models import (decode_step, decode_step_slab,  # noqa: E402
                                init_decode_cache, init_params, init_state_cache,
                                init_verify_ckpts, param_count, prefill,
                                prefill_chunk, verify_chunk, verify_chunk_slab)
from repro_torch.models import cache_ops as tops  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

ARCH = "falcon-mamba-7b"
TOL = 1e-4            # K7's plain version against Pallas / the oracle, as
                      # tests/test_kernels.py holds the Pallas kernel
F32_TOL = 2e-5        # model functions at SMOKE size, float32
MAX_LEN = 32


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))         # a writable copy


def _close(got, want, tol=F32_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _scan_inputs(rng, B, S, di, N):
    """The inputs of `tests/test_kernels.py::test_ssm_scan`, drawn with
    numpy: dt a softplus, A negative, D ones."""
    x = _rand(rng, (B, S, di), 0.5)
    dt = np.log1p(np.exp(_rand(rng, (B, S, di)) - 1.0)).astype(np.float32)
    A = -np.exp(_rand(rng, (di, N), 0.3))
    Bm = _rand(rng, (B, S, N), 0.5)
    Cm = _rand(rng, (B, S, N), 0.5)
    D = np.ones((di,), np.float32)
    return x, dt, A, Bm, Cm, D


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    tcfg = get_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _layer(weights, i=0):
    """Layer i's Mamba1 parameters on both sides (JAX cast to the model
    dtype as its model functions cast them)."""
    jcfg, jparams, _, tparams = weights
    jp = jax.tree.map(lambda a: a[i].astype(jcfg.dtype), jparams["layers"]["mamba"])
    return jp, tparams["layers"][i]["mamba"]


# ------------------------------------------------------- K7 plain version --


@pytest.mark.parametrize("B,S,di,N", [(1, 64, 256, 8), (2, 128, 512, 16), (1, 96, 256, 4)])
def test_ssm_scan_plain_matches_pallas(B, S, di, N):
    """The shapes of the JAX package's own K7 test, through the wrapper (a
    CPU tensor takes the plain version and launches nothing)."""
    args = _scan_inputs(np.random.default_rng(0), B, S, di, N)
    jargs = [jnp.asarray(a) for a in args]
    y_p, h_p = ssm_scan_pallas(*jargs, bd=128, chunk=32, interpret=True)
    y_r, h_r = ref.ssm_scan_ref(*jargs)
    y, h = k7.ssm_scan(*[_t(a) for a in args])
    assert y.shape == (B, S, di) and y.dtype == torch.float32
    assert h.shape == (B, di, N) and h.dtype == torch.float32
    for want_y, want_h in ((y_p, h_p), (y_r, h_r)):
        _close(y.numpy(), want_y, TOL)
        _close(h.numpy(), want_h, TOL)
    assert k7.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_scan_plain_h0_and_states(dtype):
    """From a random carried state, against `mamba1_scan_ref(h0=...)`; the
    states written into a caller's buffer against `mamba1_scan_states`, and
    the last of them equal to the final state bit for bit."""
    rng = np.random.default_rng(1)
    B, S, di, N = 2, 9, 48, 8
    x, dt, A, Bm, Cm, D = _scan_inputs(rng, B, S, di, N)
    h0 = _rand(rng, (B, di, N))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx, jd, jb, jc, jD = (jnp.asarray(a).astype(jdt) for a in (x, dt, Bm, Cm, D))
    y_r, h_r = jssm.mamba1_scan_ref(jx, jd, jnp.asarray(A), jb, jc, jD, h0=jnp.asarray(h0))
    y_s, hs_r = jssm.mamba1_scan_states(jx, jd, jnp.asarray(A), jb, jc, jD, h0=jnp.asarray(h0))
    tx, td, tb, tc, tD = (_t(np.asarray(a, np.float32)).to(tdt) for a in (jx, jd, jb, jc, jD))
    states = torch.full((B, S, di, N), float("nan"))
    y, h = k7.ssm_scan(tx, td, _t(A), tb, tc, tD, _t(h0), states)
    tol = TOL if dtype == "float32" else 2e-2          # one bf16 rounding of y
    assert y.dtype == tdt
    _close(y.float().numpy(), y_r, tol)
    _close(y.float().numpy(), y_s, tol)
    _close(h.numpy(), h_r, TOL)
    _close(states.numpy(), hs_r, TOL)
    assert torch.equal(states[:, -1], h)
    y0, h0_none = k7.ssm_scan(tx, td, _t(A), tb, tc, tD)     # h0=None: zeros
    y_z, h_z = jssm.mamba1_scan_ref(jx, jd, jnp.asarray(A), jb, jc, jD)
    _close(y0.float().numpy(), y_z, tol)
    _close(h0_none.numpy(), h_z, TOL)


def test_ssm_scan_checks_and_no_silent_cpu_fallback():
    rng = np.random.default_rng(2)
    args = [_t(a) for a in _scan_inputs(rng, 1, 4, 8, 4)]
    with pytest.raises(ValueError, match="want"):
        k7.ssm_scan(args[0], args[1][:, :3], *args[2:])
    with pytest.raises(TypeError):
        k7.ssm_scan(args[0], args[1], args[2].double(), *args[3:])
    with pytest.raises(TypeError):
        k7.ssm_scan(args[0], args[1].bfloat16(), *args[2:])
    meta = [a.to("meta") for a in args]
    y, h = k7.ssm_scan(*meta)                 # the dry run's: shapes on meta
    assert (y.device.type, y.shape, h.shape) == ("meta", args[0].shape,
                                                 (1, 8, args[2].shape[1]))
    assert k7.launches == 0


def _butterfly(p):
    """A one-state-a-thread body's sum over a channel's N lanes in float32:
    lane n adds lane n ^ off for off = N/2 .. 1; lane 0's value."""
    idx, off = np.arange(p.shape[1]), p.shape[1] // 2
    while off:
        p = p + p[:, idx ^ off]
        off //= 2
    return p[:, 0]


def _strided_sum(p, R):
    """K7's sum with R states a thread (csrc/ssm_scan.cu): lane l of the
    channel's L = N / R lanes holds n = l + L j in slot j; slots j and j +
    half are added inside the thread for half = R/2 .. 1, then lanes l and
    l ^ off for off = L/2 .. 1; lane 0's value."""
    rows, N = p.shape
    L = N // R
    part = p.reshape(rows, R, L).transpose(0, 2, 1).copy()    # [:, l, j] = p[:, l + L j]
    half = R // 2
    while half:
        part[:, :, :half] = part[:, :, :half] + part[:, :, half:2 * half]
        half //= 2
    q, idx, off = part[:, :, 0], np.arange(L), L // 2
    while off:
        q = q + q[:, idx ^ off]
        off //= 2
    return q[:, 0]


@pytest.mark.parametrize("N,R", [(N, R) for N in (4, 8, 16, 32) for R in (2, 4)])
def test_scan_sum_tree_matches_one_state_butterfly(N, R):
    """The sum over n of K7's R-states-a-thread body equals, bit for bit in
    float32, the butterfly of one state a thread, on products h C of a wide
    range of magnitudes; where a channel has more than one lane, a
    contiguous slot assignment (n = l R + j) would not (the test can see a
    change of tree)."""
    assert k7.plan_for(R, 1, 1, 128, 8192, N).r == R
    rng = np.random.default_rng(N * 10 + R)
    p = (rng.standard_normal((4096, N)) * 10.0 ** rng.uniform(-4, 4, (4096, N))).astype(
        np.float32)
    want = _butterfly(p)
    got = _strided_sum(p, R)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if N > R:
        contiguous = p.reshape(-1, N // R, R).transpose(0, 2, 1).reshape(-1, N)
        assert (_strided_sum(contiguous, R).view(np.int32) != want.view(np.int32)).any()


def test_scan_plan():
    """The launch plan at falcon-mamba-7b's two launch shapes (a 128-token
    chunk, a verify round of 4 x 5), at a ragged di and small N, and its
    refusals."""
    P = k7.ScanPlan
    assert k7.scan_plan(1, 128, 8192, 16) == P(4, 8, 4, 32, (256, 1), 32)
    assert k7.scan_plan(4, 5, 8192, 16) == P(4, 1, 4, 32, (256, 4), 5)
    assert k7.plan_for(2, 8, 1, 128, 8192, 16) == P(2, 8, 8, 16, (512, 1), 32)
    assert k7.plan_for(2, 1, 4, 5, 8192, 16) == P(2, 1, 8, 16, (512, 4), 5)
    assert k7.scan_plan(2, 37, 200, 16) == P(4, 8, 4, 32, (7, 2), 32)
    assert k7.scan_plan(1, 31, 200, 32) == P(4, 1, 8, 16, (13, 1), 31)
    assert k7.scan_plan(3, 5, 96, 4) == P(4, 1, 1, 128, (1, 3), 5)
    assert k7.scan_plan(1, 9, 10, 2) == P(2, 1, 1, 128, (1, 1), 9)
    assert k7.scan_plan(1, 9, 10, 1) == P(1, 1, 1, 128, (1, 1), 9)
    assert k7.scan_plan(2, 0, 8192, 16).tile == 1
    for plan in (k7.scan_plan(1, 128, 8192, 16), k7.plan_for(2, 1, 1, 128, 8192, 16)):
        assert plan.lanes * plan.channels == k7.THREADS and plan.r * plan.lanes == 16
    for N in (0, 3, 6, 64):
        with pytest.raises(ValueError, match="power of two"):
            k7.scan_plan(1, 8, 64, N)
    for r, N in ((4, 2), (1, 16), (8, 32), (3, 16)):
        with pytest.raises(ValueError, match="states a thread"):
            k7.plan_for(r, 1, 1, 8, 64, N)
    for group in (0, 2, 4, 16):
        with pytest.raises(ValueError, match="walked together"):
            k7.plan_for(4, group, 1, 8, 64, 16)


# ------------------------------------------------------ Mamba1 functions --


def test_conv_matches_jax():
    """The explicit shifted-product conv and the decode step's conv against
    `lax.conv_general_dilated` and the jnp step; a prompt shorter than the
    window sees zero history."""
    rng = np.random.default_rng(3)
    K, C = 4, 24
    w, b = _rand(rng, (K, C)), _rand(rng, (C,))
    for S in (2, 11):
        x = _rand(rng, (2, S, C))
        want = jssm.causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        _close(tssm.causal_depthwise_conv(_t(x), _t(w), _t(b)).numpy(), want)
    state, xt = _rand(rng, (2, K - 1, C)), _rand(rng, (2, C))
    jw, jy = jssm.conv_step(jnp.asarray(state), jnp.asarray(xt), jnp.asarray(w), jnp.asarray(b))
    tw, ty = tssm.conv_step(_t(state), _t(xt), _t(w), _t(b))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    _close(ty.numpy(), jy)


def test_mamba1_decode_and_chunks_match_jax(weights):
    """`mamba1_decode`, `mamba1_chunk` (all real, and right-padded with a
    true length: state frozen past it, conv tail cut at it) and
    `mamba1_chunk_states` from a carried state, one SMOKE layer, float32."""
    jcfg, _, tcfg, _ = weights
    jp, tp = _layer(weights, 1)
    rng = np.random.default_rng(4)
    d, di, N, K = jcfg.d_model, jcfg.d_inner, jcfg.ssm_state, jcfg.ssm_conv
    conv, st = _rand(rng, (2, K - 1, di)), _rand(rng, (2, di, N), 0.3)
    x1 = _rand(rng, (2, 1, d))
    jo, jconv, jst = jssm.mamba1_decode(jcfg, jp, jnp.asarray(x1), conv_state=jnp.asarray(conv),
                                        ssm_state=jnp.asarray(st))
    to, tconv, tst = tssm.mamba1_decode(tcfg, tp, _t(x1), conv_state=_t(conv), ssm_state=_t(st))
    for a, b in ((to, jo), (tconv, jconv), (tst, jst)):
        _close(a.numpy(), b)
    x = _rand(rng, (2, 7, d))
    for length in (None, 5, 1):
        jo, jtail, jh = jssm.mamba1_chunk(jcfg, jp, jnp.asarray(x), conv_state=jnp.asarray(conv),
                                          ssm_state=jnp.asarray(st), length=length)
        to, ttail, th = tssm.mamba1_chunk(tcfg, tp, _t(x), conv_state=_t(conv),
                                          ssm_state=_t(st), length=length)
        n = 7 if length is None else length
        _close(to[:, :n].numpy(), np.asarray(jo)[:, :n], msg=str(length))
        _close(ttail.numpy(), jtail, msg=str(length))
        _close(th.numpy(), jh, msg=str(length))
    jo, jcat, jhs = jssm.mamba1_chunk_states(jcfg, jp, jnp.asarray(x), conv_state=jnp.asarray(conv),
                                             ssm_state=jnp.asarray(st))
    to, tcat, ths = tssm.mamba1_chunk_states(tcfg, tp, _t(x), conv_state=_t(conv),
                                             ssm_state=_t(st))
    for a, b in ((to, jo), (tcat, jcat), (ths, jhs)):
        _close(a.numpy(), b)


# ------------------------------------------------------------ the model ---


def _assert_state_close(tstate, jstate):
    for k in ("conv", "ssm"):
        _close(tstate[k].numpy(), jstate[k], msg=k)


@pytest.mark.parametrize("n,bucket", [(23, 30), (2, 8), (3, 3)])
def test_prefill_matches_jax(weights, n, bucket):
    """Bucketed whole-prompt prefill: logits at the true length, the scan
    and conv state; a prompt shorter than the conv window (n = 2) sees zero
    history and equals its unpadded prefill."""
    jcfg, jparams, tcfg, tparams = weights
    toks = [int(t) for t in np.random.default_rng(5).integers(1, 200, size=n)]
    padded = toks + [0] * (bucket - n)
    jl, jc = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray([padded])}, MAX_LEN,
                         length=jnp.asarray(n, jnp.int32))
    tl, tc = prefill(tcfg, tparams, torch.as_tensor([padded]), MAX_LEN, length=n)
    _close(tl.numpy(), jl)
    _assert_state_close(tc, jc)
    assert int(tc["pos"]) == n and set(tc) == {"pos", "conv", "ssm"}
    el, ec = prefill(tcfg, tparams, torch.as_tensor([toks]), MAX_LEN)
    _close(tl.numpy(), el.numpy(), 1e-6)
    np.testing.assert_array_equal(tc["conv"].numpy(), ec["conv"].numpy())


def test_prefill_chunk_and_decode_match_jax(weights):
    """Chunked prefill of a 13-token prompt in right-padded chunks of 5
    threading a B=1 state (`init_state_cache`), then paged decode steps of
    a two-slot state with one free row, against the JAX functions."""
    jcfg, jparams, tcfg, tparams = weights
    toks = [int(t) for t in np.random.default_rng(6).integers(1, 200, size=13)]
    jc = jax_init_decode_cache(jcfg, 1, MAX_LEN)
    state = init_state_cache(tcfg, 1, device="cpu")
    for start in range(0, 13, 5):
        real = toks[start:start + 5]
        chunk = real + [0] * (5 - len(real))
        jl, jc = jax_prefill_chunk(jcfg, jparams, {"tokens": jnp.asarray([chunk])}, jc,
                                   length=jnp.asarray(len(real), jnp.int32))
        tl = prefill_chunk(tcfg, tparams, torch.as_tensor([chunk]), start, len(real),
                           {}, None, state=state)
        _close(tl.numpy(), jl)
    _assert_state_close(state, jc)
    # batched decode: row 0 carries the sequence, row 1 a free slot's zeros
    jb = jax_init_decode_cache(jcfg, 2, MAX_LEN)
    jb = jops.write_slot(jb, jc, 0)
    jb["pos"] = jnp.asarray([13, 0], jnp.int32)
    tb = init_state_cache(tcfg, 2, device="cpu")
    for k in tb:
        tb[k][:, 0] = state[k][:, 0]
    for t in (9, 4, 250):
        jl, jb = jax_decode_step(jcfg, jparams, jnp.asarray([[t], [0]]), jb)
        tl = decode_step(tcfg, tparams, torch.as_tensor([[t], [0]]), torch.zeros(2), {},
                         None, None, state=tb)
        _close(tl.numpy(), jl)
    _assert_state_close(tb, jb)


def test_verify_ckpts_match_jax_and_rollback_contract(weights):
    """Verify from a prefilled state: per-position logits and checkpoints
    against the JAX `verify_chunk`, the checkpoint at keep = j equal to the
    state after j decode steps (the rollback contract), on the paged
    signature and the slab one."""
    jcfg, jparams, tcfg, tparams = weights
    toks = [int(t) for t in np.random.default_rng(7).integers(1, 200, size=9)]
    jl, jc = jax_prefill(jcfg, jparams, {"tokens": jnp.asarray([toks])}, MAX_LEN)
    _, tc = prefill(tcfg, tparams, torch.as_tensor([toks]), MAX_LEN)
    cand = [5, 9, 13, 17, 21]
    jv, jnew, jck = jax_verify_chunk(jcfg, jparams, {"tokens": jnp.asarray([cand])}, dict(jc))
    state = {k: tc[k].clone() for k in ("conv", "ssm")}
    ckpts = init_verify_ckpts(init_state_cache(tcfg, 1, device="cpu"), len(cand))
    tv = verify_chunk(tcfg, tparams, torch.as_tensor([cand]), torch.zeros(1), {}, None, None,
                      None, state=state, ckpts=ckpts)
    _close(tv.numpy(), jv)
    _assert_state_close(ckpts, jck)
    _assert_state_close(state, jnew)
    # the slab signature fills the same checkpoints
    slab = {"pos": torch.tensor([9], dtype=torch.int32),
            **{k: tc[k].clone() for k in ("conv", "ssm")}}
    ck2 = init_verify_ckpts(init_state_cache(tcfg, 1, device="cpu"), len(cand))
    sv, slab = verify_chunk_slab(tcfg, tparams, torch.as_tensor([cand]), slab, ckpts=ck2)
    assert torch.equal(sv, tv) and int(slab["pos"][0]) == 9 + len(cand)
    for k in ck2:
        assert torch.equal(ck2[k], ckpts[k]), k
    # rollback contract: j decode steps give checkpoint j
    seq = {"pos": tc["pos"].clone(), **{k: tc[k].clone() for k in ("conv", "ssm")}}
    km1 = tcfg.ssm_conv - 1
    for j, t in enumerate(cand, start=1):
        dl, seq = decode_step_slab(tcfg, tparams, torch.as_tensor([[t]]), seq)
        _close(dl.numpy()[0, 0], tv.numpy()[0, j - 1])
        _close(seq["ssm"].numpy(), ckpts["ssm"][:, :, j - 1].numpy(), 1e-6)
        _close(seq["conv"].numpy(), ckpts["conv"][:, :, j:j + km1].numpy(), 1e-6)


def test_params_and_caches_match_jax(weights):
    """The bridge carries the ssm tree; `init_params` draws the same names,
    shapes and dtypes (A_log = log(1..N), D ones, zero conv bias); the
    published config counts ~7.27 B parameters; the decode cache, its byte
    count, the slab snapshot of a state and the page allocator (no pools,
    nothing per page) equal the JAX package's."""
    jcfg, jparams, tcfg, tparams = weights
    drawn = init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        for tree in (tparams, drawn):
            node = tree
            if keys[0] == "layers":
                node = tree["layers"][1]
                keys_ = keys[1:]
                want = leaf.shape[1:]
            else:
                keys_, want = keys, leaf.shape
            for k in keys_:
                node = node[k]
            assert tuple(node.shape) == tuple(want), keys
            assert node.dtype == torch.float32
    np.testing.assert_allclose(tparams["layers"][0]["mamba"]["A_log"].numpy(),
                               np.asarray(jparams["layers"]["mamba"]["A_log"][0]))
    m = drawn["layers"][0]["mamba"]
    assert torch.equal(m["A_log"][3], torch.log(torch.arange(1, tcfg.ssm_state + 1).float()))
    assert torch.equal(m["D"], torch.ones_like(m["D"])) and not m["conv_b"].any()
    assert param_count(tparams) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(jparams))
    assert abs(get_config(ARCH).param_count() - 7.27e9) < 0.01e9
    jcache = jax_init_decode_cache(jcfg, 3, MAX_LEN)
    tcache = init_decode_cache(tcfg, 3, MAX_LEN, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    assert tops.cache_nbytes(tcache) == jops.cache_nbytes(jcache)
    rng = np.random.default_rng(8)
    sub = {"pos": np.asarray(5, np.int32), "conv": _rand(rng, jcache["conv"][:, :1].shape),
           "ssm": _rand(rng, jcache["ssm"][:, :1].shape)}
    jsnap = jops.prefix_snapshot({k: jnp.asarray(v) for k, v in sub.items()}, 5)
    tsnap = tops.prefix_snapshot({k: torch.as_tensor(v) for k, v in sub.items()}, 5)
    assert tops.cache_nbytes(tsnap) == jops.cache_nbytes(jsnap)
    texp = tops.expand_snapshot(tsnap, MAX_LEN)
    for k in ("conv", "ssm"):
        np.testing.assert_array_equal(texp[k].numpy(), np.asarray(jsnap[k]))
    from repro.models.cache_ops import PageAllocator as JaxAllocator
    ja, ta = JaxAllocator(jcfg, 5, 8), tops.PageAllocator(tcfg, 5, 8, device="cpu")
    assert ta.pools == {} == ja.pools and ta.page_nbytes == ja.page_nbytes == 0
