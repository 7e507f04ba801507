"""The port's training (`repro_torch.training`) against the JAX package's,
on SMOKE qwen2.5-3b (byte vocabulary) with float32 parameters:

- three steps of `make_train_step` from one state (bridged parameters and
  optimizer state) for AdamW, Adafactor and 8-bit Adam, and for AdamW
  with microbatch=2 and a `grad_transform`: each step's loss and gradient
  norm, the parameters and the optimizer state after it (8-bit Adam's
  steps each from the JAX state, see `_codes_agree`). Weight decay
  reaches the stacked norm and bias leaves, Adafactor factors them as
  stacks and 8-bit Adam's float32 exemption counts the stacked size
  (q_block 32: a stacked (2, 64) norm is quantized, one layer's (64,)
  would not be);
- checkpoints: the JAX layout's keys, shapes and dtypes, and a roundtrip;
- crash-resume bit for bit on the port (as `tests/test_runtime.py`);
- a JAX `Trainer`'s checkpoint resumed by the port's `Trainer`.
"""
import shutil

import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.data import lm_data as jax_lm_data  # noqa: E402
from repro.data.corpus import make_swde_corpus as jax_swde_corpus  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.training import driver as jax_driver  # noqa: E402
from repro.training.optim import OptConfig as JaxOptConfig  # noqa: E402
from repro.training.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.bridge import (opt_state_from_numpy, opt_state_to_numpy,  # noqa: E402
                                params_from_numpy, params_to_numpy)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.data.corpus import make_swde_corpus  # noqa: E402
from repro_torch.training import (CrashInjected, OptConfig, Trainer,  # noqa: E402
                                  TrainerConfig, latest_step, make_optimizer,
                                  make_loss_fn, make_train_step, restore_checkpoint,
                                  save_checkpoint)
from repro_torch.training.checkpoint import host_arrays  # noqa: E402
from repro_torch.tree import flat, like  # noqa: E402

ARCH = "qwen2.5-3b"
LR = 1e-3
OPT = {"adamw": {}, "adafactor": {"name": "adafactor"},
       "adam8bit": {"name": "adam8bit", "q_block": 32}}
# float32, the same arithmetic summed in other orders: loss and gradient
# norm relative; the gradients themselves agree to ~1e-6 of a leaf's largest
# value (tests/test_torch_train_forward.py)
METRIC_RTOL = 1e-5
# a parameter after the steps, in the allclose form |a - b| / (1 + |b|):
# 1% of one step's lr. (8-bit Adam divides by a dequantized second moment
# that may be 0 where its first is not, as in the JAX package, and moves
# such entries by ~lr m / eps: both packages reach |p| ~ 50 there.) Both
# rules divide a gradient entry by a running scale of its own
# (Adam) or of its row and column (Adafactor), which magnifies the
# gradients' ~1e-6 relative noise where an entry is small. Where an entry
# is within that noise of 0, Adam's first step g / (|g| + eps) may go +lr
# in one package and -lr in the other, so those entries are held to the
# steps' size, 2 lr a step. A missing weight decay (0.1 lr |p| a step) or
# an unshared Adafactor column factor (~lr) is far outside PARAM_TOL.
PARAM_TOL = 1e-5
# 8-bit Adam's well-conditioned entries (`_codes_agree`) still divide by a
# moment rebuilt from int8 codes: 5% of lr (seen: 1.4e-5)
PARAM_TOL_8BIT = 5e-5
NEAR_ZERO = 1e-4        # a gradient entry below this fraction of its leaf's largest
STATE_RTOL = 1e-4       # a moment leaf, relative to its largest value


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    tcfg = get_smoke_config(ARCH).replace(vocab_size=lm_data.VOCAB)
    assert jcfg == jcfg.replace(**tcfg.__dict__)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):                    # a live bias path
        b = tree["layers"]["attn"][name]
        tree["layers"]["attn"][name] = (rng.standard_normal(b.shape) * 0.1).astype(b.dtype)
    toks = rng.integers(0, lm_data.VOCAB, (3, 4, 17)).astype(np.int32)
    batches = [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]
    return jcfg, tcfg, tree, batches


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _check_params(mine, theirs, grads, steps, agree, tol):
    """Parameters to `tol`, but where the step-1 gradient is near 0 or
    8-bit Adam's step is ill-conditioned (`agree` False): there only to the
    steps' size where `agree` holds, not at all where it does not."""
    for (path, a), (_, b), (_, g), (_, same) in zip(
            _leaves(mine), _leaves(theirs), _leaves(grads), _leaves(agree)):
        loose = ~same | (np.abs(g) <= NEAR_ZERO * max(float(np.abs(g).max()), 1e-30))
        err = np.abs(a - b) / (1 + np.abs(b))
        name = jax.tree_util.keystr(path)
        assert float(err[~loose].max(initial=0)) <= tol, name
        assert float(err[same].max(initial=0)) <= tol + 2 * LR * steps, name


def _codes_agree(mine, theirs, params, first: bool):
    """Per parameter entry, before a step: whether 8-bit Adam's step from
    the two states is well-conditioned -- both hold the same int8 codes for
    its two moments, and (past the first step) the second moment's code is
    not 0. A second moment quantized to 0 under a larger one in its block
    leaves v = 0.05 g^2 alone in the denominator, and the gradients' noise
    moves the step by up to ~lr. True for float32 moments and the other
    optimizers."""
    def same(path, p):
        q_m = mine.get("q", {})
        q_t = theirs.get("q", {})
        for k in jax.tree_util.keystr(path)[2:-2].split("']['"):
            q_m, q_t = q_m.get(k, {}), q_t.get(k, {})
        if "mq" not in q_m:
            return np.ones(p.shape, bool)
        ok = (q_m["mq"] == q_t["mq"]) & (q_m["vq"] == q_t["vq"])
        return ok if first else ok & (q_t["vq"] != 0)
    return jax.tree_util.tree_map_with_path(same, params)


def _check_state(mine, theirs, q_block):
    """Moments leaf by leaf; 8-bit moments dequantized, within one
    quantum (their scale) of each other: the two may round a moment to
    neighbouring int8 steps, and their scales differ by the moments'
    rounding."""
    assert np.array_equal(mine["step"], theirs["step"])
    for key in set(mine) - {"step"}:
        flat_m = {jax.tree_util.keystr(p): v for p, v in _leaves(mine[key])}
        flat_t = {jax.tree_util.keystr(p): v for p, v in _leaves(theirs[key])}
        assert flat_m.keys() == flat_t.keys()
        for name, b in flat_t.items():
            a = flat_m[name]
            assert a.shape == b.shape and a.dtype == b.dtype, name
            if name.endswith(("['mq']", "['vq']")):
                s_m = flat_m[name[:-4] + name[-4] + "s']"]
                s_t = flat_t[name[:-4] + name[-4] + "s']"]
                shape = b.shape[:-1] + (-1, q_block)
                dq_m = a.reshape(shape) * s_m[..., None]
                dq_t = b.reshape(shape) * s_t[..., None]
                # one code step, plus the scales' own difference at the largest code
                quantum = (np.maximum(s_m, s_t) + 127 * np.abs(s_m - s_t))[..., None]
                assert np.all(np.abs(dq_m - dq_t) <= quantum), name
                continue
            if name.endswith(("['ms']", "['vs']")):  # a block's max, within one of its steps
                assert np.all(np.abs(a - b) <= np.maximum(a, b) / 127 * 1.01), name
                continue
            scale = max(float(np.abs(b).max()), 1e-30)
            assert float(np.abs(a - b).max()) <= STATE_RTOL * scale, name


CASES = {"adamw": ("adamw", 0, None), "adafactor": ("adafactor", 0, None),
         "adam8bit": ("adam8bit", 0, None),
         "adamw microbatch 2 + grad_transform": ("adamw", 2, 0.5)}


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(setup, case):
    jcfg, tcfg, tree, batches = setup
    opt, micro, factor = CASES[case]
    kw = dict(lr=LR, warmup_steps=2, **OPT[opt])
    j_transform = t_transform = None
    if factor is not None:
        def j_transform(g):
            return jax.tree.map(lambda x: x * factor, g)

        def t_transform(g):
            return like(g, [x * factor for x in flat(g)])
    j_init, j_step = jax_make_train_step(jcfg, JaxOptConfig(**kw), remat=False,
                                         grad_transform=j_transform, microbatch=micro)
    j_step = jax.jit(j_step)
    t_init, t_step = make_train_step(tcfg, OptConfig(**kw), remat=False,
                                     grad_transform=t_transform, microbatch=micro)
    jp = jax.tree.map(jnp.asarray, tree)
    js = j_init(jp)
    tp = params_from_numpy(tcfg, tree, device="cpu", dtype=torch.float32)
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    # the step-1 gradients (the port's), which say where a gradient is near 0
    leaves = flat(tp)
    for t in leaves:
        t.requires_grad_(True)
    loss = make_loss_fn(tcfg, remat=False)(tp, {k: torch.as_tensor(v)
                                               for k, v in batches[0].items()})[0]
    first_grads = params_to_numpy(like(tp, torch.autograd.grad(loss, leaves)))
    for i, batch in enumerate(batches, 1):
        if opt == "adam8bit" and i > 1:
            # each step from the JAX state: an ill-conditioned entry (see
            # `_codes_agree`) moves by up to ~lr, and would move later
            # gradients everywhere
            tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu",
                                   dtype=torch.float32)
            ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
        agree = _codes_agree(opt_state_to_numpy(ts), jax.tree.map(np.asarray, js), tree,
                             first=i == 1)
        jp, js, jm = j_step(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, ts, tm = t_step(tp, ts, batch)
        for key in ("loss", "grad_norm", "ce", "aux"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=METRIC_RTOL,
                                       atol=1e-7, err_msg=f"step {i} {key}")
        _check_params(params_to_numpy(tp), jax.tree.map(np.asarray, jp), first_grads, i,
                      agree, PARAM_TOL_8BIT if opt == "adam8bit" else PARAM_TOL)
        _check_state(opt_state_to_numpy(ts), jax.tree.map(np.asarray, js),
                     OPT[opt].get("q_block", 128))


@pytest.mark.parametrize("opt", list(OPT))
def test_checkpoint_layout_and_roundtrip(setup, tmp_path, opt):
    """The payload holds the JAX checkpoint's keys, shapes and dtypes for
    {"params", "opt"}, and restores into the port's structure unchanged."""
    jcfg, tcfg, tree, _ = setup
    kw = OPT[opt]
    jp = jax.tree.map(jnp.asarray, tree)
    j_state = jax_make_train_step(jcfg, JaxOptConfig(**kw))[0](jp)
    want = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in _leaves({"params": jp, "opt": j_state})}
    tp = params_from_numpy(tcfg, tree, device="cpu", dtype=torch.float32)
    ts = make_optimizer(OptConfig(**kw))[0](tp)
    ts_bridged = opt_state_from_numpy(jax.tree.map(np.asarray, j_state), device="cpu")
    save_checkpoint(tmp_path, 3, {"params": tp, "opt": ts}, extra={"step": 3})
    assert latest_step(tmp_path) == 3
    with np.load(tmp_path / "step_00000003" / "payload.npz") as payload:
        got = {k: payload[k] for k in payload.files}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    back, extra = restore_checkpoint(tmp_path, 3, {"params": tp, "opt": ts_bridged})
    assert extra == {"step": 3}
    mine, saved = host_arrays(back), host_arrays({"params": tp, "opt": ts})
    assert mine.keys() == saved.keys() == want.keys()
    for k, v in saved.items():
        assert mine[k].dtype == v.dtype and np.array_equal(mine[k], v), k


def _trainer(cfg, ckpt_dir, total=12, ckpt_every=4, **kw):
    stream = lm_data.corpus_token_stream(make_swde_corpus())
    data = lm_data.LMBatches(stream, batch=2, seq=16)
    tcfg = TrainerConfig(total_steps=total, ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir),
                         seed=0, log_every=100)
    return Trainer(cfg, OptConfig(lr=LR, warmup_steps=2), data, tcfg, device="cpu", **kw)


def test_crash_resume_bit_exact(setup, tmp_path):
    tcfg = setup[1]
    t_a = _trainer(tcfg, tmp_path / "a")
    t_a.init()
    hist_a = t_a.run()
    t_b = _trainer(tcfg, tmp_path / "b")
    t_b.init()
    with pytest.raises(CrashInjected):
        t_b.run(failure_at=6)
    t_b.ckpt.wait()
    t_b2 = _trainer(tcfg, tmp_path / "b")
    t_b2.init()
    assert t_b2.resume()
    assert t_b2.step == 4
    t_b2.run()
    np.testing.assert_allclose(hist_a[4:], t_b2.history, rtol=0, atol=0)


def test_jax_checkpoint_resumes_in_port(setup, tmp_path):
    """A JAX Trainer runs 6 steps with a checkpoint at step 4; the port's
    Trainer resumes from that checkpoint (parameters, AdamW state, data
    cursor) and its steps 5 and 6 give the JAX run's losses."""
    jcfg, tcfg = setup[:2]
    stream = jax_lm_data.corpus_token_stream(jax_swde_corpus())
    j = jax_driver.Trainer(jcfg, JaxOptConfig(lr=LR, warmup_steps=2),
                           jax_lm_data.LMBatches(stream, batch=2, seq=16),
                           jax_driver.TrainerConfig(total_steps=6, ckpt_every=4,
                                                    ckpt_dir=str(tmp_path / "jax"),
                                                    log_every=100))
    j.init()
    hist = j.run()
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    t = _trainer(tcfg, tmp_path / "port", total=6)
    t.init()
    assert t.resume() and t.step == 4
    np.testing.assert_allclose(t.run(), hist[4:], rtol=METRIC_RTOL)


def test_trainer_runs_on_the_card_unless_asked(setup, tmp_path):
    """device=None is the CUDA device; without one the Trainer raises."""
    tcfg = setup[1]
    if torch.cuda.is_available():
        t = Trainer(tcfg, OptConfig(), None, TrainerConfig(ckpt_dir=str(tmp_path)))
        assert t.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(tcfg, OptConfig(), None, TrainerConfig(ckpt_dir=str(tmp_path)))
