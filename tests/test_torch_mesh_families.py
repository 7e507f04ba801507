"""Mesh serving of the rest of the registry in the port: the slab layout,
the draft-model drafter, and the moe, ssm, hybrid and encdec families on
gloo meshes on the CPU, one child process a rank
(`test_torch_distributed.run_ranks`). The JAX package's mesh serving
tests fail on XLA's host-device meshes on the CPU (ROADMAP.md Queue 3), so
the port's mesh engine is held to the port's single-device engine, run in
the parent on the same weights, and every combo's rows on every mesh to
the JAX single-device engine's on those weights (`bridge.params_to_numpy`).

Weights: the port's `init_params` at SMOKE size with the byte vocabulary,
seeded, with every bias, norm bias and LoRA b_* drawn non-zero (zeros would
hide a wrong shard of them). The workload is `test_torch_mesh_serving`'s: 4
prompts with a 12-token shared prefix, 2 slots, max_len 64, pages of 8,
chunks of 5, 4 new tokens each. Combos, on 1x2 and 2x2:
qwen2.5-3b slab plain and with the prefix cache and prompt lookup (the
sequence-sharded decode over K5s's plain version), qwen2.5-3b with a
qwen2.5-3b draft model, deepseek-v2-lite-16b paged (MLA, the latent rank
over `model`) and again at capacity_factor 0.1 with 4 slots and spec_k 8,
so verify rounds drop expert assignments, grok-1-314b paged (the sink
page), falcon-mamba-7b paged (Mamba1 on the rank's channels), zamba2-2.7b
paged (Mamba2 whole, the shared blocks' LoRA) and whisper-medium on the
slab (the encoder over the rank's heads, the cross K/V's heads over
`model`), and each family's other layout: deepseek-v2-lite-16b, grok-1-314b,
zamba2-2.7b and llava-next-mistral-7b on the slab with prompt lookup,
falcon-mamba-7b on the slab with the prefix cache too, whisper-medium
paged; on 1x4 qwen2.5-3b slab plain and falcon-mamba-7b paged, whose
d_inner splits four ways. Every rank's rows and the engine's `stats` must
be identical to the single-device engine's; the Mamba states, grok's K/V
pools (the sink page included, the scratch pages past the allocatable
ones not) and whisper's cross K/V are each rank's shard of the single-
device engine's, within 1e-5 of a tensor's largest value (the `model`
sums add in another order than one card's products).

The slab's prefill and verify attend the rank's query heads over the KV
heads they read (`layers._rank_kv`): each way of grouping them, against
every head's attention, on the CPU.

And K5s's plain version (`decode_attention_stats_plain`) on the CPU:
against the statistics `distributed.decode._partial_attn` computed before
it called K5s, and, combined over the shards, against K5's plain version,
at several shard starts and lengths, length 0 among them."""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.serving.engine import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402

from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.distributed.sharding import (local_shard, pool_specs,  # noqa: E402
                                              serving_cache_specs)
from repro_torch.kernels import decode_attention as k5  # noqa: E402
from repro_torch.kernels import flash_attention as k2  # noqa: E402
from repro_torch.kernels import moe_gating as k6  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.serving.engine import Request, ServingEngine  # noqa: E402
from test_torch_distributed import run_ranks  # noqa: E402

SHARED = [7, 3, 9, 4, 2, 8, 1, 6, 5, 7, 3, 2]
PROMPTS = [SHARED + [10 + i, 20 + i, 30 + i] for i in range(4)]
# the low-capacity combo: six requests of different lengths leave dead rows
LOWCAP_PROMPTS = [SHARED + [10 + i, 20 + i, 30 + i][: 1 + i % 3] for i in range(6)]
LOWCAP_NEW = [3, 9, 5, 12, 4, 7]
BASE = dict(slots=2, max_len=64, prefix_min_len=4, page_size=8, chunk_size=5)
# name: (arch, engine arguments beyond BASE, state compared)
COMBOS = {
    "qwen-slab": ("qwen2.5-3b", dict(kv_layout="slab"), ()),
    "qwen-slab-pc-pl": ("qwen2.5-3b", dict(kv_layout="slab", prefix_cache=True,
                                           spec_decode="prompt_lookup"), ()),
    "qwen-draft": ("qwen2.5-3b", dict(prefix_cache=True, spec_decode="draft"), ()),
    "deepseek": ("deepseek-v2-lite-16b", dict(prefix_cache=True,
                                              spec_decode="prompt_lookup"), ()),
    "deepseek-lowcap": ("deepseek-v2-lite-16b", dict(slots=4, prefix_cache=True,
                                                     spec_decode="prompt_lookup", spec_k=8),
                        ()),
    "grok": ("grok-1-314b", dict(prefix_cache=True, spec_decode="prompt_lookup"),
             ("pool:k", "pool:v")),
    "falcon": ("falcon-mamba-7b", dict(prefix_cache=True, spec_decode="prompt_lookup"),
               ("conv", "ssm")),
    "zamba": ("zamba2-2.7b", dict(prefix_cache=True, spec_decode="prompt_lookup"),
              ("conv", "ssm")),
    "whisper": ("whisper-medium", dict(kv_layout="slab", prefix_cache=True,
                                       spec_decode="prompt_lookup"), ("ck", "cv")),
    # the other layout of each family (the prefix cache where its slab
    # snapshot holds a state: falcon-mamba-7b's)
    "deepseek-slab": ("deepseek-v2-lite-16b", dict(kv_layout="slab",
                                                   spec_decode="prompt_lookup"), ()),
    "grok-slab": ("grok-1-314b", dict(kv_layout="slab", spec_decode="prompt_lookup"), ()),
    "falcon-slab": ("falcon-mamba-7b", dict(kv_layout="slab", prefix_cache=True,
                                            spec_decode="prompt_lookup"), ("conv", "ssm")),
    "zamba-slab": ("zamba2-2.7b", dict(kv_layout="slab", spec_decode="prompt_lookup"),
                   ("conv", "ssm")),
    "llava-slab": ("llava-next-mistral-7b", dict(kv_layout="slab",
                                                 spec_decode="prompt_lookup"), ()),
    "whisper-paged": ("whisper-medium", dict(prefix_cache=True, spec_decode="prompt_lookup"),
                      ("ck", "cv")),
}
RUNS = [(name, shape) for shape in ("1x2", "2x2") for name in COMBOS] + \
    [("qwen-slab", "1x4"), ("falcon", "1x4")]
ARCHS = sorted({arch for arch, _, _ in COMBOS.values()})
DRAFT_SEED = 7


def _weights(arch, seed):
    """SMOKE parameters from the port's `init_params`, with biases, norm
    biases and LoRA b_* drawn non-zero."""
    cfg = get_smoke_config(arch).replace(vocab_size=lm_data.VOCAB)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, gen, device="cpu")

    def perturb(tree):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            if isinstance(v, (dict, list)):
                perturb(v)
            elif k in ("b", "bq", "bk", "bv") or str(k).startswith("b_"):
                v.copy_(torch.randn(v.shape, generator=gen) * 0.02)
    perturb(params)
    return params


def _engine_kw(name):
    arch, kw, _ = COMBOS[name]
    return arch, {**BASE, **kw}


def _requests(name, Req=Request):
    if name == "deepseek-lowcap":
        return [Req(rid=i, prompt=p, max_new=n, eos_id=-1, shared_len=len(SHARED))
                for i, (p, n) in enumerate(zip(LOWCAP_PROMPTS, LOWCAP_NEW))]
    return [Req(rid=i, prompt=p, max_new=4, eos_id=-1, shared_len=len(SHARED))
            for i, p in enumerate(PROMPTS)]


def _config(name, smoke=get_smoke_config):
    """The combo's config: SMOKE with the byte vocabulary (the draft model's
    is qwen2.5-3b's), capacity_factor 0.1 for the low-capacity combo; the
    JAX package's with `smoke=jax_smoke_config`."""
    arch = _engine_kw(name)[0] if name in COMBOS else name
    cfg = smoke(arch).replace(vocab_size=lm_data.VOCAB)
    return cfg.replace(capacity_factor=0.1) if name == "deepseek-lowcap" else cfg


def _specs(eng, name, mesh):
    """The specs of `_state`'s tensors of a single-device engine on `mesh`
    (a stand-in): `pool_specs` and `serving_cache_specs` of the whole
    tensors."""
    pools = pool_specs(eng.alloc.pools, mesh) if eng.paged else {}
    cache = serving_cache_specs(eng.cfg, eng.cache, mesh, eng.slots)
    return {key: pools[key[len("pool:"):]] if key.startswith("pool:") else cache[key]
            for key in COMBOS[name][2]}


def _state(eng, name):
    """The compared tensors of an engine after its run: per-slot state, or
    the K/V pools up to the allocatable pages."""
    out = {}
    for key in COMBOS[name][2]:
        if key.startswith("pool:"):
            k = key[len("pool:"):]
            out[key] = eng.alloc.pools[k][:, :eng.alloc.num_pages].contiguous()
        else:
            out[key] = eng.cache[key]
    return out


CHILD = """
sys.path.insert(0, %(tests)r)
from repro_torch.launch.mesh import axis_rank, make_serving_mesh
from repro_torch.serving.engine import ServingEngine
import test_torch_mesh_families as T

weights = {arch: torch.load(os.path.join(OUT, arch + ".pt")) for arch in T.ARCHS}
draft = (T._config("qwen2.5-3b"), torch.load(os.path.join(OUT, "draft.pt")))
for shape, names in %(runs)r:
    mesh = make_serving_mesh(tuple(int(n) for n in shape.split("x")), device="cpu")
    coords = {a: axis_rank(mesh, a) for a in ("data", "model")}
    for name in names:
        arch, kw = T._engine_kw(name)
        if kw.get("spec_decode") == "draft":
            kw["draft_model"] = draft
        eng = ServingEngine(T._config(name), weights[arch], mesh=mesh, **kw)
        eng.submit_many(T._requests(name))
        done = eng.run()
        torch.save(T._state(eng, name), os.path.join(OUT, f"{name}@{shape}-r{RANK}.pt"))
        emit(**{f"{name}@{shape}": {"rows": {str(i): done[i].out for i in done},
                                    "stats": dict(eng.stats), "coords": coords}})
"""


class _StandIn:
    """A mesh for `local_shard`: the JAX `Mesh`'s axis_names and shape."""

    def __init__(self, shape):
        self.axis_names = ("data", "model")
        self.shape = dict(zip(self.axis_names, shape))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(single-device results and states, each mesh rank's results), the
    two child groups run once."""
    tmp = tmp_path_factory.mktemp("mesh_families")
    weights = {arch: _weights(arch, 0) for arch in ARCHS}
    draft = _weights("qwen2.5-3b", DRAFT_SEED)
    for arch, params in weights.items():
        torch.save(params, tmp / f"{arch}.pt")
    torch.save(draft, tmp / "draft.pt")
    single, drops = {}, {}
    real = tlayers.moe_apply
    for name in COMBOS:
        arch, kw = _engine_kw(name)
        cfg = _config(name)
        counted = []

        def counting(cfg, p, x, **kw_):
            T, d = x.shape[0] * x.shape[1], x.shape[2]
            _, idx = k6.moe_gating_plain((x.reshape(T, d) @ p["router"]).float(),
                                         cfg.moe_top_k)
            flat = idx.reshape(-1).long()
            pos = (torch.nn.functional.one_hot(flat, cfg.n_experts).cumsum(0) - 1) \
                .gather(1, flat[:, None])[:, 0]
            counted.append((x.shape[0], int((pos >= tlayers.moe_capacity(cfg, T)).sum())))
            return real(cfg, p, x, **kw_)
        tlayers.moe_apply = counting
        try:
            if kw.get("spec_decode") == "draft":
                kw["draft_model"] = (_config("qwen2.5-3b"), draft)
            eng = ServingEngine(cfg, weights[arch], device="cpu", **kw)
            eng.submit_many(_requests(name))
            done = eng.run()
        finally:
            tlayers.moe_apply = real
        drops[name] = counted
        single[name] = {"rows": {str(i): done[i].out for i in done},
                        "stats": json.loads(json.dumps(dict(eng.stats))),
                        "state": _state(eng, name),
                        "specs": {shape: _specs(eng, name, _StandIn(shape))
                                  for shape in ((1, 2), (2, 2), (1, 4))}}
    tests = str(Path(__file__).resolve().parent)
    two = run_ranks(CHILD % {"tests": tests, "runs": [("1x2", list(COMBOS))]}, 2, tmp)
    four = run_ranks(CHILD % {"tests": tests, "runs": [("2x2", list(COMBOS)),
                                                       ("1x4", ["qwen-slab", "falcon"])]},
                     4, tmp)
    return tmp, single, drops, two, four


@pytest.fixture(scope="module")
def jax_rows(served):
    """Each combo's rows from the JAX single-device engine, on the port's
    weights of `served` bridged to the JAX package's tree."""
    tmp = served[0]

    def jax_params(path):
        return jax.tree.map(jnp.asarray, params_to_numpy(torch.load(path)))
    out = {}
    for name in COMBOS:
        arch, kw = _engine_kw(name)
        if kw.get("spec_decode") == "draft":
            kw["draft_model"] = (_config("qwen2.5-3b", jax_smoke_config),
                                 jax_params(tmp / "draft.pt"))
        eng = JaxEngine(_config(name, jax_smoke_config), jax_params(tmp / f"{arch}.pt"), **kw)
        eng.submit_many(_requests(name, JaxRequest))
        out[name] = {str(i): [int(t) for t in r.out] for i, r in eng.run().items()}
    return out


@pytest.mark.parametrize("name", list(COMBOS))
def test_mesh_family_matches_jax_single_device(served, jax_rows, name):
    """Every mesh rank's rows, on every mesh the combo runs on, are the JAX
    single-device engine's on the same weights."""
    _, single, _, two, four = served
    assert single[name]["rows"] == jax_rows[name]
    shapes = [shape for n, shape in RUNS if n == name]
    for shape in shapes:
        for r, res in enumerate(two if shape == "1x2" else four):
            assert res[f"{name}@{shape}"]["rows"] == jax_rows[name], (shape, r)


@pytest.mark.parametrize("name,shape", RUNS, ids=[f"{n}@{s}" for n, s in RUNS])
def test_mesh_family_matches_single_device(served, name, shape):
    tmp, single, _, two, four = served
    ranks = two if shape == "1x2" else four
    dims = tuple(int(n) for n in shape.split("x"))
    stand_in = _StandIn(dims)
    want = single[name]
    for r, res in enumerate(ranks):
        got = res[f"{name}@{shape}"]
        assert got["rows"] == want["rows"], (r, got["rows"], want["rows"])
        assert got["stats"] == want["stats"], r
        state = torch.load(tmp / f"{name}@{shape}-r{r}.pt")
        for key, full in want["state"].items():
            shard = local_shard(full, want["specs"][dims][key], stand_in, got["coords"])
            assert state[key].shape == shard.shape, (r, key, state[key].shape, shard.shape)
            scale = max(float(full.abs().max()), 1e-30)
            err = float((state[key].float() - shard.float()).abs().max()) / scale
            assert err <= 1e-5, (r, key, err)
            assert float(full.abs().max()) > 0, key          # a state was written


def test_combos_reach_their_paths(served):
    """Each combo's single-device run takes the path it stands for: prefix
    hits where the prefix cache is on, verify rounds with a drafter, and
    the draft model's tokens (another seed's model: every one rejected and
    rolled back; prompt lookup finds no n-gram in these prompts, so its
    rounds verify the pending token alone)."""
    _, single, _, _, _ = served
    for name, (_, kw, _) in COMBOS.items():
        st = single[name]["stats"]
        if kw.get("prefix_cache"):
            assert st["prefix_hits"] > 0, name
        if kw.get("spec_decode"):
            assert st["spec_rounds"] > 0, name
    st = single["qwen-draft"]["stats"]
    assert st["draft_tokens"] > 0, st


def test_lowcap_verify_rounds_drop_assignments(served):
    """The low-capacity combo's verify rounds (4 rows) drop expert
    assignments on the single-device engine, so its mesh cases hold which
    assignments drop, not only that none do."""
    _, single, drops, _, _ = served
    assert single["deepseek-lowcap"]["stats"]["spec_rounds"] > 0
    assert sum(n for b, n in drops["deepseek-lowcap"] if b == 4) > 0, drops


def test_slab_kv_bytes_count_the_global_cache(served):
    """`kv_bytes_peak` counts the global slab, sequence over `model` and
    rows over `data`: the single-device engine's count on every rank."""
    _, single, _, two, four = served
    want = single["qwen-slab"]["stats"]["kv_bytes_peak"]
    assert want > 0
    for res in two + four:
        for key in ("qwen-slab@1x2", "qwen-slab@2x2", "qwen-slab@1x4"):
            if key in res:
                assert res[key]["stats"]["kv_bytes_peak"] == want


# ------------------------------------------------ the rank's heads --


class _Rank:
    """A stand-in `MeshRank` for `layers._rank_kv`: its model rank."""

    def __init__(self, model_rank):
        self.model_rank = model_rank


RANK_KV_CASES = [  # (H, Hkv, n_model): whole groups, one KV head, widened, G = 1
    (4, 2, 2), (8, 2, 8), (6, 2, 3), (4, 4, 2), (12, 4, 2)]


@pytest.mark.parametrize("H,Hkv,n_model", RANK_KV_CASES,
                         ids=[f"H{h}kv{k}x{n}" for h, k, n in RANK_KV_CASES])
def test_rank_kv_heads_match_every_head(H, Hkv, n_model):
    """K2's plain version over `_rank_kv`'s query and KV heads gives each
    rank's heads of the every-head attention, bit for bit."""
    cfg = get_smoke_config("qwen2.5-3b").replace(n_heads=H, n_kv_heads=Hkv)
    g = torch.Generator().manual_seed(H * 100 + Hkv * 10 + n_model)
    S, Smax, D, ps = 5, 16, 8, 4
    q = torch.randn((1, S, H, D), generator=g)
    k = torch.randn((1, Smax, Hkv, D), generator=g)
    v = torch.randn((1, Smax, Hkv, D), generator=g)
    table = torch.arange(Smax // ps, dtype=torch.int32)

    def attend(q, k, v):
        return k2.chunk_prefill_attention_plain(q[0], tlayers.slab_pages(k, ps),
                                                tlayers.slab_pages(v, ps), table, 0)
    whole = attend(q, k, v)
    h = H // n_model
    for r in range(n_model):
        qr = q[:, :, r * h:(r + 1) * h]
        qk, kk, vk, back = tlayers._rank_kv(cfg, qr, k, v, _Rank(r))
        assert qk.shape[2] <= H and kk.shape[2] <= Hkv
        got = back(attend(qk, kk, vk)[None])[0]
        assert torch.equal(got, whole[:, r * h:(r + 1) * h]), r


# --------------------------------------------------------------- K5s --


def _old_stats(q, k_shard, v_shard, length, start):
    """The local statistics `_partial_attn` computed before K5s: masked
    scores against the shard, their max, exp against it (zeros where
    masked), the denominator and the p-weighted V, all float32."""
    B, H, D = q.shape
    Hkv = k_shard.shape[2]
    qg = q.reshape(B, 1, Hkv, H // Hkv, D)
    s = torch.einsum("bqhgd,bshd->bhgqs", qg.float(), k_shard.float()) * D ** -0.5
    pos = start + torch.arange(k_shard.shape[1])
    lengthv = torch.as_tensor(length)
    ok = (pos[None, :] < lengthv[:, None]) if lengthv.ndim else (pos < lengthv)[None, :]
    s = s.masked_fill(~ok[:, None, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]), torch.zeros_like(s))
    acc = torch.einsum("bhgqs,bshd->bhgqd", p, v_shard.float())
    return m.reshape(B, H), p.sum(-1).reshape(B, H), acc.reshape(B, H, D)


K5S_CASES = [  # (S, shards, lengths)
    (64, 2, [17, 64, 33, 1]),
    (64, 4, [0, 16, 15, 48]),
    (96, 3, [0, 0, 95, 200]),
    (48, 1, [5, 48, 0, 30]),
]


@pytest.mark.parametrize("S,shards,lengths", K5S_CASES,
                         ids=[f"S{s}x{n}-{'_'.join(map(str, ls))}" for s, n, ls in K5S_CASES])
def test_k5s_plain_matches_old_statistics_and_k5(S, shards, lengths):
    g = torch.Generator().manual_seed(S * 10 + shards)
    B, H, Hkv, D = 4, 8, 2, 16
    q = torch.randn((B, H, D), generator=g)
    k = torch.randn((B, S, Hkv, D), generator=g)
    v = torch.randn((B, S, Hkv, D), generator=g)
    lens = torch.as_tensor(lengths, dtype=torch.int32)
    n = S // shards
    parts = []
    for i in range(shards):
        ks, vs = k[:, i * n:(i + 1) * n].contiguous(), v[:, i * n:(i + 1) * n].contiguous()
        m, l, acc = k5.decode_attention_stats(q, ks, vs, lens, i * n)
        assert k5.stats_launches == 0                       # CPU tensors: no launch
        om, ol, oacc = _old_stats(q, ks, vs, lens.long(), i * n)
        torch.testing.assert_close(m, om, rtol=0, atol=0)
        torch.testing.assert_close(l, ol, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(acc, oacc, rtol=1e-6, atol=1e-6)
        dead = lens <= i * n                                 # no key in this shard
        assert torch.isneginf(m[dead]).all() and (l[dead] == 0).all()
        assert (acc[dead] == 0).all()
        parts.append((m, l, acc))
    # the combine of `distributed.decode`, in one process
    m_star = torch.stack([m for m, _, _ in parts]).amax(0)
    m_safe = torch.where(torch.isfinite(m_star), m_star, torch.zeros_like(m_star))
    l_sum = torch.zeros_like(m_star)
    acc_sum = torch.zeros((B, H, D))
    for m, l, acc in parts:
        w = torch.where(torch.isfinite(m), torch.exp(m - m_safe), torch.zeros_like(m))
        l_sum = l_sum + l * w
        acc_sum = acc_sum + acc * w[..., None]
    out = acc_sum / torch.clamp(l_sum, min=1e-30)[..., None]
    want = k5.decode_attention_plain(q, k, v, lens)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    assert (out[lens == 0] == 0).all()
