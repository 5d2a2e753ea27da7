"""Port parity of the trainable model: ``AttentionASPPUNetTrain`` (v1, and
v2 with ``--no_aspp``) against the flax model in train and eval mode —
logits, the updated BatchNorm statistics and the gradients of the criterion
— and the weight converters between the two packages' layouts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from att_aspp_unet_tpu.config import LossConfig as JLossConfig
from att_aspp_unet_tpu.config import ModelConfig as JModelConfig
from att_aspp_unet_tpu.models import AttentionASPPUNet as JModel
from att_aspp_unet_tpu.train.losses import build_criterion as j_criterion
from att_aspp_unet_tpu_torch.config import LossConfig, ModelConfig
from att_aspp_unet_tpu_torch.nn.train_blocks import dropout
from att_aspp_unet_tpu_torch.train.losses import build_criterion
from att_aspp_unet_tpu_torch.utils.convert import (
    init_variables, jax_variables_to_torch, jax_variables_to_train_model,
    torch_tensors_to_jax, train_model_to_jax_variables)
from .test_torch_threads import one_torch_thread  # noqa: F401

BASE_C, S, B = 4, 64, 4
VARIANTS = {"v1": {}, "v2_no_aspp": dict(gate_variant="v2", use_aspp=False)}


def _batch():
    """[0, 1] images with a bright disc per positive sample (sample 1 has an
    empty mask), masks of the discs."""
    rng = np.random.default_rng(0)
    x = rng.random((B, 1, S, S)).astype(np.float32)
    y = np.zeros((B, 1, S, S), np.float32)
    yy, xx = np.mgrid[:S, :S]
    for i in range(B):
        if i == 1:
            continue
        cy, cx = rng.integers(S // 4, 3 * S // 4, 2)
        blob = (yy - cy) ** 2 + (xx - cx) ** 2 <= (S // 6 + i) ** 2
        y[i, 0][blob] = 1.0
        x[i, 0][blob] += 0.8
    return x, y


def _tree_max_err(want_tree, got_tree, scale_by_leaf: bool):
    """Largest |want - got| over the leaves, each divided by the leaf's
    max-abs when ``scale_by_leaf``; with the leaf's path."""
    errs = []

    def one(path, want, got):
        want = np.asarray(want, np.float64)
        err = np.abs(want - np.asarray(got, np.float64)).max()
        if scale_by_leaf:
            err /= max(np.abs(want).max(), 1e-30)
        errs.append((float(err), jax.tree_util.keystr(path)))

    jax.tree_util.tree_map_with_path(one, want_tree, got_tree)
    return max(errs)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def case(request):
    """One variant: seeded weights with random BN statistics, a batch, and
    the flax side's results (compiled once per variant): the f32 forward in
    train mode (logits, new batch_stats) and in eval mode, and the criterion's
    gradients in f64."""
    kw = VARIANTS[request.param]
    cfg = ModelConfig(base_c=BASE_C, compute_dtype="float32",
                      aspp_dropout=0.0, **kw)
    v = init_variables(cfg, 1)
    rng = np.random.default_rng(1)

    def randomize(tree):
        if "mean" in tree:
            tree["mean"][:] = rng.standard_normal(tree["mean"].shape) * 0.1
            tree["var"][:] = rng.random(tree["var"].shape) + 0.5
            return
        for sub in tree.values():
            randomize(sub)

    randomize(v["batch_stats"])
    x, y = _batch()
    jx, jy = jnp.asarray(x.transpose(0, 2, 3, 1)), \
        jnp.asarray(y.transpose(0, 2, 3, 1))
    out = {"cfg": cfg, "v": v, "x": x, "y": y}

    jm = JModel.from_config(JModelConfig(base_c=BASE_C,
                                         compute_dtype="float32",
                                         aspp_dropout=0.0, **kw))
    (logits, psis), upd = jax.jit(lambda var: jm.apply(
        var, jx, train=True, mutable=["batch_stats"]))(v)
    out["train_logits"] = np.asarray(logits).transpose(0, 3, 1, 2)
    out["train_psis"] = [None if p is None else
                         np.asarray(p).transpose(0, 3, 1, 2) for p in psis]
    out["new_stats"] = jax.device_get(upd["batch_stats"])
    logits, _ = jax.jit(lambda var: jm.apply(var, jx, train=False))(v)
    out["eval_logits"] = np.asarray(logits).transpose(0, 3, 1, 2)

    # The reference gradients are computed in f64: XLA's f32 gradients of
    # this model stray from the f64 ones by up to 16 % of a leaf's max-abs
    # (BatchNorm's E[x^2] - mean^2 over few values cancels), while the
    # port's f32 gradients stay within 4e-5 of them.
    with jax.enable_x64(True):
        jm64 = JModel.from_config(JModelConfig(
            base_c=BASE_C, compute_dtype="float64", param_dtype="float64",
            aspp_dropout=0.0, **kw))
        crit = j_criterion(JLossConfig(), "main")
        f64 = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), t)

        def loss_fn(params):
            (lg, _), _ = jm64.apply(
                {"params": params, "batch_stats": f64(v["batch_stats"])},
                jnp.asarray(jx, jnp.float64), train=True,
                mutable=["batch_stats"])
            return crit(lg, jy)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(f64(v["params"]))
        out["loss64"] = float(loss)
        out["grads64"] = jax.device_get(grads)
    return out


def test_train_mode_forward_and_statistics_match_flax(case):
    """f32: logits within 1e-4 of flax's (range ~5-9; summation order of the
    convolutions and of the BN statistics) and the psi maps too, the updated
    running statistics (0.9 old + 0.1 batch, biased variance) within 1e-5."""
    model = jax_variables_to_train_model(case["v"], case["cfg"]).train()
    with torch.no_grad():
        logits, psis = model(torch.from_numpy(case["x"]))
    np.testing.assert_allclose(logits.numpy(), case["train_logits"], rtol=0,
                               atol=1e-4)
    for got, want in zip(psis, case["train_psis"]):
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    stats = train_model_to_jax_variables(model)["batch_stats"]
    err, where = _tree_max_err(case["new_stats"], stats, scale_by_leaf=False)
    assert err <= 1e-5, (err, where)


def test_eval_mode_forward_matches_flax(case):
    model = jax_variables_to_train_model(case["v"], case["cfg"]).eval()
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(case["x"]))
    np.testing.assert_allclose(logits.numpy(), case["eval_logits"], rtol=0,
                               atol=1e-4)
    # running statistics are read, not updated, at eval
    stats = train_model_to_jax_variables(model)["batch_stats"]
    err, _ = _tree_max_err(case["v"]["batch_stats"], stats, False)
    assert err == 0.0


def test_gradients_of_the_criterion_match_flax(case):
    """The criterion (Dice + BCE + 0.05 Sobel edge, main stage) through the
    train-mode forward: the port's f32 gradients within 1e-4 of each leaf's
    max-abs of flax's f64 gradients; the loss within 1e-5 relative."""
    model = jax_variables_to_train_model(case["v"], case["cfg"]).train()
    logits, _ = model(torch.from_numpy(case["x"]))
    loss = build_criterion(LossConfig(), "main")(
        logits, torch.from_numpy(case["y"]))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    assert float(loss.detach()) == pytest.approx(case["loss64"], rel=1e-5)
    got = torch_tensors_to_jax(dict(zip(names, grads)), case["cfg"])["params"]
    err, where = _tree_max_err(case["grads64"], got, scale_by_leaf=True)
    assert err <= 1e-4, (err, where)


def test_weight_round_trip_is_exact_and_eval_equals_the_served_model(case):
    """JAX variables -> train model -> JAX variables is the identity; the
    train model in eval mode and the BN-folded serving model of
    ``jax_variables_to_torch`` give the same logits (f32, atol 1e-4: BN
    folded into an affine rounds differently)."""
    model = jax_variables_to_train_model(case["v"], case["cfg"]).eval()
    back = train_model_to_jax_variables(model)
    jax.tree_util.tree_map(np.testing.assert_array_equal, case["v"], back)
    served = jax_variables_to_torch(case["v"], case["cfg"])
    x = torch.from_numpy(case["x"])
    with torch.no_grad():
        np.testing.assert_allclose(model(x)[0].numpy(), served(x).numpy(),
                                   rtol=0, atol=1e-4)


def test_parameter_names_are_the_flax_paths():
    """Every leaf of flax's init for the variant is a state-dict key of the
    train model (the flax path joined by dots) and nothing else is; the
    differential learning rate labels read these names."""
    for kw in VARIANTS.values():
        cfg = ModelConfig(base_c=BASE_C, compute_dtype="float32", **kw)
        jm = JModel.from_config(JModelConfig(base_c=BASE_C, **kw))
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), train=False))
        want = set()
        jax.tree_util.tree_map_with_path(
            lambda path, _: want.add(".".join(str(p.key) for p in path[1:])),
            shapes)
        model = jax_variables_to_train_model(init_variables(cfg, 0), cfg)
        assert set(model.state_dict()) == want


def test_dropout_is_flax_dropout():
    """Kept values divided by 1 - rate, the rest 0, drawn from the given
    generator (the same seed gives the same mask); the identity at eval and
    at rate 0."""
    x = torch.rand(4, 8, 16, 16) + 0.5
    g = lambda: torch.Generator().manual_seed(3)
    y = dropout(x, 0.1, True, g())
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.9, rtol=0, atol=0)
    assert abs(kept.float().mean().item() - 0.9) < 0.01
    assert torch.equal(y, dropout(x, 0.1, True, g()))
    assert dropout(x, 0.1, False, g()) is x
    assert dropout(x, 0.0, True, g()) is x
    # the model draws it after the ASPP projection in training mode only
    cfg = ModelConfig(base_c=BASE_C, compute_dtype="float32")
    model = jax_variables_to_train_model(init_variables(cfg, 0), cfg).train()
    xb = torch.from_numpy(_batch()[0])
    with torch.no_grad():
        a = model(xb, generator=g())[0]
        b = model(xb, generator=g())[0]
        c = model(xb, generator=torch.Generator().manual_seed(4))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
