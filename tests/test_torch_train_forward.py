"""The port's training forward against the JAX package's, for every family:
the seven SMOKE configs of the registry's families (dense, moe with MLA and
with standard attention, ssm, hybrid, vlm, encdec) with bridged float32
parameters. For each, on one batch made from a seed with numpy: `forward`'s
logits and aux, the loss of `make_loss_fn` and its gradient for every
parameter (each port group stacked and compared with its JAX leaf), and
`remat=True` against `remat=False` in the port, bit for bit.

Every parameter the JAX init draws as a constant (norm scales, biases, the
zero LoRA b_*, conv biases, D) is moved off it with seeded noise, so that
no path hides behind a one or a zero. One compiled JAX function per config
gives the forward and the gradient together."""
import pytest

torch = pytest.importorskip("torch")
import torch_threads  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import forward as jax_forward  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.training.train_step import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import forward  # noqa: E402
from repro_torch.training import make_loss_fn  # noqa: E402
from repro_torch.tree import flat, like  # noqa: E402

ARCHS = ["qwen2.5-3b", "deepseek-v2-lite-16b", "grok-1-314b", "falcon-mamba-7b",
         "zamba2-2.7b", "llava-next-mistral-7b", "whisper-medium"]
B, S = 2, 16
# float32 throughout; the two packages sum their products in other orders
# (seen: logits within 3.2e-7, every gradient leaf within 1.1e-6 of its
# largest value)
LOGIT_TOL = 2e-6        # logits and the loss, absolute (|logits| < 1)
GRAD_TOL = 1e-5         # a gradient leaf, relative to its largest value


def batch_for(cfg, seed=0) -> dict:
    """Tokens and next-token labels from a seed, with the family's inputs:
    seeded image embeddings (vlm) or encoder frames (encdec)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, 1024)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def jax_tree(arch: str, seed=0):
    """The JAX init as numpy, every constant leaf moved off its constant."""
    jcfg = jax_smoke_config(arch)
    tree = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)

    def jitter(a):
        if a.size > 1 and np.all(a == a.flat[0]):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jcfg, jax.tree.map(jitter, tree)


def port_loss_and_grads(tcfg, params, batch, remat):
    for t in flat(params):
        t.requires_grad_(True)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, aux = make_loss_fn(tcfg, remat=remat)(params, tb)
    grads = torch.autograd.grad(loss, flat(params))
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, like(params, grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    jcfg, tree = jax_tree(arch)
    tcfg = get_smoke_config(arch)
    assert jcfg == jcfg.replace(**tcfg.__dict__)       # field-for-field
    batch = batch_for(jcfg)
    jloss_fn = jax_make_loss_fn(jcfg, remat=False)

    @jax.jit
    def reference(p, b):
        return jax_forward(jcfg, p, b), jax.value_and_grad(jloss_fn, has_aux=True)(p, b)
    (jlogits, jaux), ((jloss, jparts), jgrads) = reference(
        jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})

    params = params_from_numpy(tcfg, tree, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        logits, aux = forward(tcfg, params, batch)
    assert logits.shape == jlogits.shape and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-6)
    if jcfg.family == "moe":
        assert float(aux) > 0

    loss, parts, grads = port_loss_and_grads(tcfg, params, batch, remat=False)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(float(parts["ce"]), float(jparts["ce"]), rtol=0,
                               atol=LOGIT_TOL)
    mine = jax.tree_util.tree_flatten_with_path(params_to_numpy(grads))[0]
    theirs = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jgrads))[0]
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(mine, theirs):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        scale = max(float(np.abs(b).max()), 1e-6)
        err = float(np.abs(a - b).max())
        assert err <= GRAD_TOL * scale, (jax.tree_util.keystr(path), err, scale)

    # remat recomputes every block in the backward pass: the same bits
    rloss, _, rgrads = port_loss_and_grads(tcfg, params, batch, remat=True)
    assert torch.equal(rloss, loss)
    assert all(torch.equal(a, b) for a, b in zip(flat(rgrads), flat(grads)))
