"""Training on a (data, model) mesh in the port: `forward(mesh=)`, the loss
and the three optimizers with gradients through the collectives, MoE
grouped dispatch (`layers.set_moe_groups`, K6's grouped launch), the
`Trainer` on a mesh with its elastic restore, and `launch/specs.py`.

The JAX package's mesh training tests fail on XLA's host-device meshes on
the CPU (ROADMAP.md Queue 3), so each mesh run is held to the port's own
single-device step on the same weights, run in the parent, and that step
to the JAX single-device step on those weights (bridged with
`bridge.params_to_numpy`). The meshes are gloo groups on the CPU, one
child process a rank (`test_torch_distributed.run_ranks`), one child set a
mesh shape, each running all its cases; each rank compares its shards
with its slice of the single-device tensors (`Sharding.local`) and
reports the largest errors. Tolerances are the JAX test's
(tests/test_distributed.py:56-58): the loss to rtol 1e-5, every parameter
to atol 2e-5. Each step's gradient (before the clip) is compared too,
every entry to atol 2e-5 and each leaf to GRAD_RTOL of its largest entry;
the gradient is what holds the entries where Adam's first step is
ill-conditioned (`ILL`).

Cases:
- the JAX test's own: SMOKE qwen3-32b (n_kv_heads 2, its q/k norms drawn
  away from 1), batch 8 x 16, OptConfig(lr=1e-3, warmup_steps=1), one
  step of AdamW, Adafactor and 8-bit Adam each on 1x2, 2x1 and 2x2, the
  optimizer states compared too (8-bit Adam's int8 codes to one code: a
  moment within the steps' float noise of a rounding boundary may round
  either way);
- one AdamW step of deepseek-v2-lite-16b (MLA, K6, ungrouped: every rank
  runs every row), falcon-mamba-7b (K7), zamba2-2.7b, llava-next-mistral-7b
  (image embeddings) and whisper-medium (K2's non-causal form) on 2x2,
  with biases, norm biases and LoRA b_* drawn non-zero;
- microbatch=2 on 2x2 against the single-device microbatched step;
- a (pod 2, data 2, model 1) mesh, each pod's (data, model) mesh stepping
  its half of the batch with `make_pod_grad_sync(compress=False)` as the
  `grad_transform`, against the single-device step on the whole batch;
- deepseek-v2-lite-16b with set_moe_groups(2) on 2x1, each rank running
  only its group's rows, against the single-device grouped step;
- a `Trainer` on 2x2 that checkpoints at step 2 and crashes at step 3,
  resumed on 1x2 (the restored shards bit for bit the written global
  arrays), its history against an uninterrupted 1x2 run and a
  single-device run, and the checkpoint read by JAX's
  `restore_checkpoint`.

In the parent: grouped `moe_apply` and a grouped train step against JAX,
with aux 0, capacity per group and the ungrouped fallback where G does not
divide B S; K6 grouped's plain version against the JAX vmap of
`_moe_dispatch_group`'s gating and numbering; `launch/specs.py` against
JAX `input_specs` on every registry id x applicable shape, and
`default_opt_cfg` / `default_microbatch` on the five meshes of the
sharding tests.
"""
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.configs.shapes import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs.shapes import applicable as jax_applicable  # noqa: E402
from repro.launch import specs as jax_specs  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.training.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.training.optim import OptConfig as JaxOptConfig  # noqa: E402
from repro.training.train_step import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro.training.train_step import make_train_step as jax_make_train_step  # noqa: E402

from repro_torch.bridge import params_to_numpy  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.data.corpus import make_swde_corpus  # noqa: E402
from repro_torch.distributed.compression import make_pod_grad_sync  # noqa: E402
from repro_torch.distributed.sharding import (MeshRank, make_constrain,  # noqa: E402
                                              opt_state_shardings, param_shardings,
                                              param_specs, shard_params)
from repro_torch.kernels import moe_gating as k6  # noqa: E402
from repro_torch.launch import specs as port_specs  # noqa: E402
from repro_torch.launch.mesh import axis_rank, make_test_mesh  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.training import (CrashInjected, OptConfig, Trainer,  # noqa: E402
                                  TrainerConfig, make_train_step)
from repro_torch.tree import at, keystr, map_leaves  # noqa: E402
from test_torch_distributed import run_ranks  # noqa: E402

B, S = 8, 16
LR = 1e-3
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-5
# Adam's first step is g / (|g| + eps): where a gradient entry is within
# ~10 eps of 0 (ILL) the float noise of the gradient's sums, which the
# mesh adds in another order than one device, is a share of |g| + eps, and
# the step may move the entry by anything up to lr either way (seen: 2.4e-5
# on a zamba2-2.7b entry whose single-device gradient is 1e-10). SMOKE's
# random Mamba and encoder blocks have thousands of such entries, each
# with a gradient at the noise floor. Their parameters, other than exact
# zeros (an embedding row that no token reads has a 0 gradient
# everywhere), are held by their gradient, which is well-conditioned:
# every gradient entry within PARAM_ATOL, and each leaf's largest gradient
# error within GRAD_RTOL of the leaf's largest gradient entry, so that a
# wrong sum on a leaf whose gradient is small everywhere shows too. Every
# other parameter entry is held to PARAM_ATOL.
ILL = 10 * OptConfig().eps
GRAD_RTOL = 1e-4
STATE_RTOL = 1e-4          # a float moment or factor, relative to its leaf's largest value
QWEN = "qwen3-32b"
OPTS = ("adamw", "adafactor", "adam8bit")
MESHES = ("1x2", "2x1", "2x2")
FAMILIES = ("deepseek-v2-lite-16b", "falcon-mamba-7b", "zamba2-2.7b",
            "llava-next-mistral-7b", "whisper-medium")
GROUPS = 2
POD = "qwen3-pods"
# case: (arch, optimizer, microbatch, moe groups, the meshes it runs on)
CASES = {**{f"{QWEN}-{o}": (QWEN, o, 0, 0, MESHES) for o in OPTS},
         **{f"{a}-adamw": (a, "adamw", 0, 0, ("2x2",)) for a in FAMILIES},
         "qwen3-microbatch": (QWEN, "adamw", 2, 0, ("2x2",)),
         # a (pod 2, data 2, model 1) mesh on the 2x2 set's four ranks (`step_case`)
         POD: (QWEN, "adamw", 0, 0, ("2x2",)),
         "deepseek-grouped": ("deepseek-v2-lite-16b", "adamw", 0, GROUPS, ("2x1",))}
RUNS = [(c, m) for c, spec in CASES.items() for m in spec[4]]
TRAIN_ARCH = "qwen2.5-3b"
TRAIN_B = 4


def _cfg(arch, smoke=get_smoke_config):
    cfg = smoke(arch)
    return cfg.replace(n_kv_heads=2) if arch == QWEN else cfg


def _opt(name, cls=OptConfig):
    return cls(name=name, lr=LR, warmup_steps=1)


def _weights(arch, seed=0):
    """SMOKE float32 parameters from the port's `init_params`, seeded, with
    every bias, norm bias and LoRA b_* drawn non-zero and the q/k and
    latent norms' scales drawn around 1 (a wrong shard of a replicated
    leaf would hide behind zeros and ones)."""
    cfg = _cfg(arch)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(cfg, gen, device="cpu", dtype=torch.float32)

    def perturb(tree):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            if isinstance(v, (dict, list)):
                perturb(v)
            elif k in ("b", "bq", "bk", "bv") or str(k).startswith("b_"):
                v.copy_(torch.randn(v.shape, generator=gen) * 0.02)
            elif k in ("q_norm", "k_norm", "kv_norm"):
                v.copy_(1 + torch.randn(v.shape, generator=gen) * 0.1)
    perturb(params)
    return params


def _batch(arch, seed=1):
    """Batch 8 x 16 from numpy: tokens and labels, llava's image embeddings,
    whisper's frames."""
    cfg = _cfg(arch)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, 1024)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return batch


def step_case(case, params, mesh=None):
    """One train step of `case` from `params` (global, float32): on one
    device, or on `mesh` (a DeviceMesh) over the rank's shards. The POD
    case builds a (pod 2, data 2, model 1) mesh over the same ranks: each
    pod steps its half of the batch on its (data, model) mesh, and
    `make_pod_grad_sync(compress=False)` means the gradients over the pods,
    which is the global batch's step. Returns (params, opt_state, metrics,
    grads): the gradient the optimizer's clip receives (on a mesh the
    rank's shards of the global gradient); on a mesh the parameters are
    `MeshParams`, their `.mesh` the one that cut them."""
    arch, opt, micro, groups, _ = CASES[case]
    cfg = _cfg(arch)
    batch = _batch(arch)
    tp = constrain = transform = None
    if mesh is not None and case == POD:
        pods = make_test_mesh(2, 1, multi_pod=True, device="cpu")
        mesh, half = pods["data", "model"], B // 2
        rows = slice(axis_rank(pods, "pod") * half, (axis_rank(pods, "pod") + 1) * half)
        batch = {k: v[rows] for k, v in batch.items()}
        transform = make_pod_grad_sync(pods, compress=False)
    if mesh is not None:
        params = shard_params(cfg, params, mesh)
        tp = MeshRank(cfg, params, None)
        constrain = make_constrain(mesh, batch["tokens"].shape[0])
    seen = {}

    def capture(grads):
        grads = grads if transform is None else transform(grads)
        seen["grads"] = grads
        return grads
    tlayers.set_moe_groups(groups)
    try:
        init, step = make_train_step(cfg, _opt(opt), constrain=constrain, microbatch=micro,
                                     grad_transform=capture, mesh=tp)
        return (*step(params, init(params), batch), seen["grads"])
    finally:
        tlayers.set_moe_groups(0)


def loose_entries(grads):
    """Per parameter entry, whether its single-device gradient is within
    ILL of 0 and not 0 (Adam's first step is ill-conditioned there)."""
    return map_leaves(lambda keys, index, g: (g != 0) & (g.abs() <= ILL), grads)


def _zero_errors() -> dict:
    return {"params": 0.0, "n_loose": 0, "n": 0, "grads": 0.0, "grads_rel": 0.0}


def param_errors(out, a, b, loose):
    """Fold one parameter's errors into `out`: the largest |a - b| over
    its well-conditioned entries ("params"), and the count of the others
    ("n_loose"), which `grad_errors` holds."""
    d = (a.detach() - b).abs()
    out["params"] = max(out["params"], _largest(d[~loose]))
    out["n_loose"] += int(loose.sum())
    out["n"] += d.numel()


def grad_errors(out, a, b):
    """Fold one gradient leaf's errors into `out`: the largest |a - b|
    ("grads") and that over the leaf's largest |b| ("grads_rel"; 0 where
    both are 0 everywhere, infinite where only b is)."""
    err, scale = _largest((a - b).abs()), _largest(b.abs())
    out["grads"] = max(out["grads"], err)
    out["grads_rel"] = max(out["grads_rel"], err / scale if scale else
                           (0.0 if err == 0 else float("inf")))


def _largest(t) -> float:
    return float(t.max()) if t.numel() else 0.0


def _assert_params(got, tag):
    assert got["params"] <= PARAM_ATOL, (tag, got)
    assert got["grads"] <= PARAM_ATOL, (tag, got)
    assert got["grads_rel"] <= GRAD_RTOL, (tag, got)


def _trainer(ckpt_dir, mesh=None, total=5):
    cfg = get_smoke_config(TRAIN_ARCH).replace(vocab_size=lm_data.VOCAB)
    stream = lm_data.corpus_token_stream(make_swde_corpus())
    data = lm_data.LMBatches(stream, batch=TRAIN_B, seq=S)
    tcfg = TrainerConfig(total_steps=total, ckpt_every=2, ckpt_dir=str(ckpt_dir), seed=0,
                         log_every=100)
    kw = {"device": "cpu"} if mesh is None else {
        "mesh": mesh, "constrain": make_constrain(mesh, TRAIN_B)}
    return Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=2), data, tcfg, **kw)


def compare_shards(cfg, params, opt, grads, ref, mesh):
    """A rank's largest errors against its slices (`Sharding.local`) of the
    single-device tensors `ref` ({"params", "opt", "grads"}, global):
    `param_errors`' and `grad_errors`', {"state": max |a - b| / max |b| of
    a float state leaf, "codes": max |a - b| of an int8 leaf, "n_codes":
    int8 entries apart}."""
    pspecs = param_specs(cfg, ref["params"], mesh)
    out = {**_zero_errors(), "state": 0.0, "codes": 0, "n_codes": 0}

    def walk(mine, want, shard, fn, extra=None):
        if isinstance(want, dict):
            for k in want:
                walk(mine[k], want[k], shard[k], fn, None if extra is None else extra[k])
        elif isinstance(want, list):
            for i, (a, b, sh) in enumerate(zip(mine, want, shard)):
                walk(a, b, sh, fn, None if extra is None else extra[i])
        else:
            fn(mine, shard.local(want), *(() if extra is None else (shard.local(extra),)))

    def param(a, b, loose):
        param_errors(out, a, b, loose)

    def state(a, b):
        if b.dtype == torch.int8:
            d = (a.int() - b.int()).abs()
            out["codes"] = max(out["codes"], int(d.max()))
            out["n_codes"] += int((d > 0).sum())
        elif b.ndim:
            scale = max(float(b.abs().max()), 1e-30)
            out["state"] = max(out["state"], float((a - b).abs().max()) / scale)
    shardings = param_shardings(cfg, ref["params"], mesh)
    walk(params, ref["params"], shardings, param, ref["loose"])
    walk(grads, ref["grads"], shardings, lambda a, b: grad_errors(out, a, b))
    walk(opt, ref["opt"], opt_state_shardings(cfg, ref["opt"], pspecs, mesh), state)
    return out


CHILD = """
sys.path.insert(0, %(tests)r)
from repro_torch.launch.mesh import make_test_mesh
import test_torch_mesh_training as T

for shape, runs in %(runs)r:
    dims = tuple(int(n) for n in shape.split("x"))
    mesh = make_test_mesh(*dims, device="cpu")
    for case in runs:
        ref = torch.load(os.path.join(OUT, case + ".ref.pt"))
        params, opt, metrics, grads = T.step_case(case, ref["init"], mesh)
        errs = T.compare_shards(T._cfg(T.CASES[case][0]), params, opt, grads, ref,
                                params.mesh)
        emit(**{f"{case}@{shape}": {"loss": float(metrics["loss"]),
                                    "grad_norm": float(metrics["grad_norm"]), **errs}})
    if shape in T.TRAINER_RUNS:
        emit(**T.TRAINER_RUNS[shape](mesh, OUT))
"""


def _trainer_crash(mesh, out):
    """2x2: checkpoint at step 2, crash at step 3."""
    t = _trainer(Path(out) / "ckpt", mesh)
    t.init()
    crashed = False
    try:
        t.run(failure_at=3)
    except CrashInjected:
        crashed = True
    t.ckpt.wait()
    return {"crash": {"history": t.history, "crashed": crashed}}


def _trainer_resume(mesh, out):
    """1x2: resume the 2x2 checkpoint (its shards against the written
    global arrays, bit for bit) and run on; and an uninterrupted run."""
    t = _trainer(Path(out) / "ckpt", mesh)
    t.init()
    resumed = t.resume()
    with np.load(Path(out) / "ckpt" / "step_00000002" / "payload.npz") as z:
        arrays = {k: torch.from_numpy(z[k]) for k in z.files}
    exact = True

    def check(keys, index, shard, sharding):
        nonlocal exact
        arr = arrays[keystr(keys)]
        exact &= bool(torch.equal(shard, sharding.local(arr if index is None else arr[index])))
    for name, tree in (("params", t.params), ("opt", t.opt_state)):
        map_leaves(lambda k, i, x: check((name,) + tuple(k), i, x, at(t.shardings[name], k, i)),
                   tree)
    step = t.step
    t.run()
    whole = _trainer(Path(out) / "ckpt_whole", mesh)
    whole.init()
    whole.run()
    return {"resume": {"resumed": resumed, "step": step, "exact": exact,
                       "history": t.history, "uninterrupted": whole.history}}


TRAINER_RUNS = {"2x2": _trainer_crash, "1x2": _trainer_resume}


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """(tmp, the single-device results, {case@shape: a rank's report} per
    rank): the 2x2 set runs first (it writes the Trainer's checkpoint),
    then 1x2 (which resumes it), then 2x1."""
    tmp = tmp_path_factory.mktemp("mesh_training")
    single = {}
    for case, (arch, *_rest) in CASES.items():
        init = _weights(arch)
        params, opt, metrics, grads = step_case(case, _clone(init))
        torch.save({"init": init, "params": params, "opt": opt, "grads": grads,
                    "loose": loose_entries(grads)}, tmp / f"{case}.ref.pt")
        single[case] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                        "params": params}
    tests = str(Path(__file__).resolve().parent)
    ranks = {}
    for shape in ("2x2", "1x2", "2x1"):
        runs = [c for c, m in RUNS if m == shape]
        world = int(shape[0]) * int(shape[2])
        ranks[shape] = run_ranks(CHILD % {"tests": tests, "runs": [(shape, runs)]}, world, tmp)
    return tmp, single, ranks


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


@pytest.mark.parametrize("case,shape", RUNS, ids=[f"{c}@{m}" for c, m in RUNS])
def test_mesh_step_matches_single_device(meshes, case, shape):
    """Every rank's loss, gradient norm, gradient shards, parameter shards
    and optimizer state shards after one step against the single-device
    step's (on the pod mesh a rank's loss is its pod's: the pods' mean is
    the step's)."""
    _, single, ranks = meshes
    want = single[case]
    losses = [res[f"{case}@{shape}"]["loss"] for res in ranks[shape]]
    if case == POD:                   # ranks pod-major: pod 0 is ranks 0, 1
        np.testing.assert_allclose((losses[0] + losses[2]) / 2, want["loss"], rtol=LOSS_RTOL)
        losses = [want["loss"]] * len(losses)
    for r, res in enumerate(ranks[shape]):
        got = res[f"{case}@{shape}"]
        np.testing.assert_allclose(losses[r], want["loss"], rtol=LOSS_RTOL, err_msg=str(r))
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=LOSS_RTOL,
                                   err_msg=str(r))
        _assert_params(got, r)
        assert got["state"] <= STATE_RTOL, (r, got)
        assert got["codes"] <= 1, (r, got)


@pytest.mark.parametrize("opt", OPTS)
def test_single_device_step_matches_jax(meshes, opt):
    """The port's single-device step of the JAX test's case, which the mesh
    runs are held to, against the JAX step on the same weights."""
    tmp, single, _ = meshes
    case = f"{QWEN}-{opt}"
    ref = torch.load(tmp / f"{case}.ref.pt")
    _assert_jax_step(QWEN, opt, ref, single[case], groups=0)


def _assert_jax_step(arch, opt, ref, mine, groups):
    """The port's single-device step (`ref`'s gradient and loose entries,
    `mine`'s loss and parameters) against the JAX step on the same weights
    and its gradient (`jax.grad` of the JAX loss), by `_assert_params`."""
    init = ref["init"]
    jcfg = _cfg(arch, jax_smoke_config)
    params = jax.tree.map(jnp.asarray, params_to_numpy(init))
    init_fn, step = jax_make_train_step(jcfg, _opt(opt, JaxOptConfig))
    loss_fn = jax_make_loss_fn(jcfg)
    jax_layers.set_moe_groups(groups)
    try:
        p1, _, m1 = jax.jit(step)(params, init_fn(params), _batch(arch))
        jgrads = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))(params, _batch(arch))
    finally:
        jax_layers.set_moe_groups(0)
    np.testing.assert_allclose(mine["loss"], float(m1["loss"]), rtol=LOSS_RTOL)

    def numpy_leaves(tree):
        return [torch.from_numpy(np.array(a)) for a in jax.tree.leaves(tree)]
    want = numpy_leaves(jax.tree.map(np.asarray, p1))
    got = numpy_leaves(params_to_numpy(mine["params"]))
    loose = numpy_leaves(params_to_numpy(ref["loose"]))
    errs = _zero_errors()
    for a, b, m in zip(got, want, loose):
        param_errors(errs, a, b, m)
    for a, b in zip(numpy_leaves(params_to_numpy(ref["grads"])), numpy_leaves(jgrads)):
        grad_errors(errs, a, b)
    _assert_params(errs, arch)


def test_grouped_step_matches_jax(meshes):
    """The single-device grouped step that the 2x1 run is held to, against
    the JAX step with set_moe_groups(2)."""
    tmp, single, _ = meshes
    ref = torch.load(tmp / "deepseek-grouped.ref.pt")
    _assert_jax_step("deepseek-v2-lite-16b", "adamw", ref, single["deepseek-grouped"],
                     groups=GROUPS)


def test_trainer_crash_resumed_on_another_mesh(meshes):
    """A 2x2 Trainer checkpoints at step 2 and crashes at step 3; a 1x2
    Trainer resumes it with each shard the written global array's slice
    bit for bit, and its steps 3-5 are an uninterrupted 1x2 run's and a
    single-device run's; the 2x2 steps are the single-device run's."""
    tmp, _, ranks = meshes
    alone = _trainer(tmp / "ckpt_single")
    alone.init()
    hist = alone.run()
    for res in ranks["2x2"]:
        assert res["crash"]["crashed"]
        np.testing.assert_allclose(res["crash"]["history"], hist[:3], rtol=LOSS_RTOL)
    for res in ranks["1x2"]:
        got = res["resume"]
        assert got["resumed"] and got["step"] == 2 and got["exact"]
        np.testing.assert_allclose(got["history"], got["uninterrupted"][2:], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["history"], hist[2:], rtol=LOSS_RTOL)


def test_mesh_checkpoint_reads_in_jax(meshes):
    """The 2x2 Trainer's checkpoint, written as global arrays by one rank,
    is the JAX layout: JAX's `restore_checkpoint` reads it into the JAX
    Trainer's tree, every leaf of the shape JAX makes, and its parameters
    are the single-device run's after two steps."""
    tmp, _, _ = meshes
    jcfg = jax_smoke_config(TRAIN_ARCH).replace(vocab_size=lm_data.VOCAB)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    from repro.training.optim import make_optimizer as jax_make_optimizer
    like = {"params": jparams, "opt": jax_make_optimizer(JaxOptConfig())[0](jparams)}
    tree, extra = jax_restore(tmp / "ckpt", 2, like)
    assert extra["step"] == 2
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(like)):
        assert a.shape == b.shape and a.dtype == b.dtype
    alone = _trainer(tmp / "ckpt_two", total=2)
    alone.init()
    alone.run()
    want = jax.tree_util.tree_flatten_with_path(params_to_numpy(alone.params))[0]
    for (path, a), b in zip(want, jax.tree.leaves(tree["params"])):
        np.testing.assert_allclose(np.asarray(b), a, rtol=0, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------- grouped MoE (parent) ----

MOE = "deepseek-v2-lite-16b"


def _moe_inputs(cfg, T_rows=B, seed=2):
    """The first MoE layer's parameters of `_weights(MOE)` and a random
    input (T_rows, S, d), as the port's and the JAX package's."""
    p = _weights(MOE)["layers"][0]["moe"]
    x = np.random.default_rng(seed).standard_normal((T_rows, S, cfg.d_model)).astype(
        np.float32)
    jp = jax.tree.map(jnp.asarray, params_to_numpy({"moe": p})["moe"])
    return p, x, jp


@pytest.mark.parametrize("groups", [2, 4, 3])
def test_grouped_moe_apply_matches_jax(groups):
    """`moe_apply` under set_moe_groups(G) in both packages: G = 2 and 4
    divide B S and dispatch grouped (aux 0); G = 3 does not, and both fall
    back to ungrouped dispatch with its load-balance aux."""
    cfg = _cfg(MOE)
    jcfg = _cfg(MOE, jax_smoke_config)
    p, x, jp = _moe_inputs(cfg)
    tlayers.set_moe_groups(groups)
    jax_layers.set_moe_groups(groups)
    try:
        y, aux = tlayers.moe_apply(cfg, p, torch.from_numpy(x), return_aux=True)
        jy, jaux = jax_layers.moe_apply(jcfg, jp, jnp.asarray(x), return_aux=True)
    finally:
        tlayers.set_moe_groups(0)
        jax_layers.set_moe_groups(0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=2e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    grouped = (B * S) % groups == 0
    assert (float(aux) == 0.0) == grouped
    if not grouped:
        np.testing.assert_array_equal(y.numpy(), tlayers.moe_apply(
            cfg, p, torch.from_numpy(x)).numpy())


def test_grouped_capacity_is_per_group():
    """Each group numbers its assignments against moe_capacity(cfg, T / G)
    with its own slots: the grouped numbering is the ungrouped numbering of
    each group alone, and at a capacity factor low enough to drop, a
    group's drops depend only on its own tokens."""
    cfg = _cfg(MOE).replace(capacity_factor=0.3)
    T, G, E, K = B * S, GROUPS, cfg.n_experts, cfg.moe_top_k
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal((T, E)).astype(
        np.float32))
    C = tlayers.moe_capacity(cfg, T // G)
    w, idx, slot, kept = k6.moe_gating(logits, K, C, groups=G)
    assert int(slot.max()) <= E * C
    dropped = 0
    for g, part in enumerate(logits.chunk(G)):
        rows = slice(g * T // G * K, (g + 1) * T // G * K)
        gw, gi, gs, gk = k6.moe_gating(part, K, C)
        assert torch.equal(slot[rows], gs) and torch.equal(kept[rows], gk)
        counts = torch.bincount(gs[gs < E * C] // C, minlength=E)
        assert int(counts.max()) <= C
        dropped += int((gs == E * C).sum())
    assert dropped > 0
    # the ungrouped numbering of the same logits differs: capacity is per call
    _, _, slot_all, _ = k6.moe_gating(logits, K, tlayers.moe_capacity(cfg, T))
    assert not torch.equal(slot_all, slot)


def _jax_group_numbering(logits, k, C):
    """The gating and numbering lines of the JAX `_moe_dispatch_group` for
    one group of router logits (Tg, E): (weights, indices, slot, kept)."""
    E = logits.shape[-1]
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    top_w, top_i = lax.top_k(probs, k)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    flat_e = top_i.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1, flat_e[:, None], axis=1)[:, 0]
    keep = pos < C
    return top_w, top_i, jnp.where(keep, flat_e * C + pos, E * C), top_w.reshape(-1) * keep


@pytest.mark.parametrize("T,E,k,G,cf", [(128, 64, 6, 2, 1.25), (128, 64, 6, 4, 0.5),
                                        (128, 8, 2, 2, 1.0), (96, 8, 2, 3, 0.4)])
def test_k6_grouped_plain_matches_jax_vmap(T, E, k, G, cf):
    """K6 grouped's plain version against `jax.vmap` of the JAX
    `_moe_dispatch_group`'s gating and numbering over the G groups: slots,
    indices and the kept mask exactly, weights and kept weights within
    1e-6 (the two softmaxes round apart)."""
    cfg = _cfg(MOE).replace(n_experts=E, moe_top_k=k, capacity_factor=cf)
    C = tlayers.moe_capacity(cfg, T // G)
    logits = np.random.default_rng(T + E + G).standard_normal((T, E)).astype(np.float32)
    w, idx, slot, kept = k6.moe_gating_plain(torch.from_numpy(logits), k, C, G)
    jw, ji, js, jk = jax.vmap(lambda lg: _jax_group_numbering(lg, k, C))(
        jnp.asarray(logits).reshape(G, T // G, E))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji).reshape(T, k))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(js).reshape(-1))
    np.testing.assert_array_equal(kept.numpy() > 0, np.asarray(jk).reshape(-1) > 0)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw).reshape(T, k), rtol=0, atol=1e-6)
    np.testing.assert_allclose(kept.numpy(), np.asarray(jk).reshape(-1), rtol=0, atol=1e-6)


# ------------------------------------------------------ launch/specs.py ----

SPEC_CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES
              if jax_applicable(jax_get_config(a), s)[0]]


@pytest.mark.parametrize("arch,shape", SPEC_CELLS, ids=[f"{a}-{s}" for a, s in SPEC_CELLS])
def test_input_specs_match_jax(arch, shape):
    """`input_specs` at mesh=None: every leaf a meta tensor of JAX
    `input_specs`'s shape and dtype (the JAX side under `jax.eval_shape`,
    nothing allocated), parameters per layer against the stacked leaves,
    the optimizer state by JAX leaf path."""
    mine = port_specs.input_specs(arch, shape)
    theirs = jax_specs.input_specs(arch, shape)
    assert sorted(mine) == sorted(theirs)
    for key in theirs:
        if key == "opt_cfg":
            assert mine[key].__dict__ == theirs[key].__dict__
            continue
        want = _jax_shapes(theirs[key])
        got = _port_shapes(mine[key], key)
        assert got == want, (key, set(got) ^ set(want))


def _jax_shapes(tree) -> dict:
    flat_, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): (tuple(x.shape), str(jnp.dtype(x.dtype)))
            for p, x in flat_}


def _port_shapes(tree, key) -> dict:
    """{JAX keystr: (shape, dtype)} of an `Abstract` or a tree of them,
    layer stacks stacked (`tree.leaves`); every tensor on the meta device."""
    from repro_torch.tree import leaves
    if isinstance(tree, port_specs.Abstract):
        assert tree.value.device.type == "meta"
        return {"": (tree.shape, str(tree.dtype).removeprefix("torch."))}
    out = {}
    for path, group, stacked in leaves(port_specs.values(tree)):
        assert all(t.device.type == "meta" for t in group), path
        shape = ((len(group),) if stacked else ()) + tuple(group[0].shape)
        out[path] = (shape, str(group[0].dtype).removeprefix("torch."))
    return out


# the five meshes of tests/test_torch_sharding.py
MESH_SHAPES = [(1, 2), (2, 2), (4, 1), (1, 4), (2, 16, 16)]


class _JaxStandIn:
    def __init__(self, shape):
        self.axis_names = ("pod", "data", "model")[-len(shape):]
        self.shape = dict(zip(self.axis_names, shape))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_default_opt_cfg_and_microbatch_match_jax(arch):
    """`default_opt_cfg` per id, and `default_microbatch` per applicable
    shape on the five meshes of the sharding tests (shape-only stand-ins),
    against JAX's."""
    cfg, jcfg = port_specs.get_config(arch), jax_get_config(arch)
    assert port_specs.default_opt_cfg(cfg).__dict__ == jax_specs.default_opt_cfg(jcfg).__dict__
    for dims in MESH_SHAPES:
        mesh = _JaxStandIn(dims)
        for name in SHAPES:
            assert port_specs.default_microbatch(cfg, SHAPES[name], mesh) == \
                jax_specs.default_microbatch(jcfg, JAX_SHAPES[name], mesh), (dims, name)
