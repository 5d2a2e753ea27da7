"""Port parity of training's parts that hold no model: the losses and
``sobel_gradients``, the augmentation body given the JAX package's draws, the
data pipeline, the learning-rate schedule and the AdamW updates, each
against the JAX package on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from att_aspp_unet_tpu.config import AugmentConfig as JAugmentConfig
from att_aspp_unet_tpu.config import LossConfig as JLossConfig
from att_aspp_unet_tpu.config import TrainConfig as JTrainConfig
from att_aspp_unet_tpu.io import write_gray_png
from att_aspp_unet_tpu.ops.image import sobel_gradients as j_sobel
from att_aspp_unet_tpu.train import augment as ja
from att_aspp_unet_tpu.train import data as jdata
from att_aspp_unet_tpu.train import losses as jl
from att_aspp_unet_tpu.train import train_loop as jtl
from att_aspp_unet_tpu_torch.config import AugmentConfig, LossConfig, \
    ModelConfig, TrainConfig
from att_aspp_unet_tpu_torch.ops.image import sobel_gradients
from att_aspp_unet_tpu_torch.train import augment as ta
from att_aspp_unet_tpu_torch.train import data as tdata
from att_aspp_unet_tpu_torch.train import losses as tl
from att_aspp_unet_tpu_torch.train import train_loop as ttl
from att_aspp_unet_tpu_torch.utils.convert import (_leaf_to_torch,
                                                   init_variables,
                                                   jax_variables_to_train_model,
                                                   torch_tensors_to_jax)
from .test_torch_threads import one_torch_thread  # noqa: F401

# losses: f32 on both sides in the same formulas; sums over at most 1024
# pixels in another order differ by a few f32 ulps
LOSS_RTOL = 1e-6


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


def _logits_targets(rng, B=4, H=16, W=16):
    logits = (rng.normal(size=(B, 1, H, W)) * 2).astype(np.float32)
    # exact zeros: a pixel whose features are all zero has logit = bias
    logits[0, 0, :2, :3] = 0.0
    targets = (rng.random((B, 1, H, W)) > 0.6).astype(np.float32)
    targets[1] = 0.0                       # one empty-mask sample
    return logits, targets


def _close(got, want, rtol=LOSS_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= rtol * np.maximum(np.abs(want), 1e-6)), \
        (got, want)


@pytest.mark.parametrize("name,masked", [
    (n, m) for n in ("dice_loss", "tversky_loss", "bce_with_logits",
                     "edge_loss") for m in (False, True)]
    + [("combo_loss", False), ("iou_score", False)])
def test_loss_and_its_gradient_match_jax(rng, name, masked):
    """Every loss and its gradient with respect to the logits (which
    includes JAX's conventions at l == 0: jnp.maximum splits the gradient,
    jnp.abs takes +1), with and without the positive-sample mask."""
    l, t = _logits_targets(rng)
    kw = {}
    if masked:
        m = t.reshape(len(t), -1).sum(1) > 0
        kw_j, kw_t = {"sample_mask": jnp.asarray(m)}, \
            {"sample_mask": torch.from_numpy(m)}
    else:
        kw_j = kw_t = kw
    jf, tf = getattr(jl, name), getattr(tl, name)
    want = float(jf(_nhwc(l), _nhwc(t), **kw_j))
    lt = torch.from_numpy(l).requires_grad_(name != "iou_score")
    got = tf(lt, torch.from_numpy(t), **kw_t)
    _close(float(got.detach()), want)
    if name == "iou_score":
        return
    jg = np.asarray(jax.grad(lambda a: jf(a, _nhwc(t), **kw_j))(_nhwc(l)))
    tg = torch.autograd.grad(got, lt)[0].numpy().transpose(0, 2, 3, 1)
    # per-pixel gradients ~1e-3: 1e-6 of the largest
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6 * np.abs(jg).max())


@pytest.mark.parametrize("case", ["main", "finetune", "all_empty", "tversky",
                                  "no_edge"])
def test_build_criterion_matches_jax(rng, case):
    l, t = _logits_targets(rng)
    if case == "all_empty":
        t = np.zeros_like(t)
    kw = {"tversky": dict(loss_type="tversky"),
          "no_edge": dict(edge_weight=0.0)}.get(case, {})
    stage = "finetune" if case == "finetune" else "main"
    jc = jl.build_criterion(JLossConfig(**kw), stage)
    tc = tl.build_criterion(LossConfig(**kw), stage)
    want = float(jc(_nhwc(l), _nhwc(t)))
    lt = torch.from_numpy(l).requires_grad_()
    got = tc(lt, torch.from_numpy(t))
    _close(float(got.detach()), want)
    jg = np.asarray(jax.grad(lambda a: jc(a, _nhwc(t)))(_nhwc(l)))
    tg = torch.autograd.grad(got, lt)[0].numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6 * np.abs(jg).max())


def test_sobel_gradients_match_jax(rng):
    x = rng.random((2, 3, 12, 17)).astype(np.float32)
    jgx, jgy = j_sobel(jnp.asarray(x))
    gx, gy = sobel_gradients(torch.from_numpy(x))
    # integer taps, nine terms summed in the same order: equal
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jgx))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jgy))


# --- augmentation -----------------------------------------------------------

B, H, W = 4, 48, 64
# every transform switched on with high probability, so each is exercised
AUG_KW = dict(affine_p=0.9, elastic_p=0.9, gamma_p=0.9,
              brightness_contrast_p=0.9)


@pytest.fixture(scope="module")
def aug_case():
    """A batch, the JAX package's draws for it from one key (the keys that
    ``augment_batch`` itself derives) and its outputs, computed once."""
    rng = np.random.default_rng(7)
    imgs = (rng.random((B, H, W)) * 255).astype(np.uint8)
    msks = np.zeros((B, H, W), np.uint8)
    msks[:, 10:30, 12:40] = 255
    msks[2] = 0
    jcfg = JAugmentConfig(**AUG_KW)
    key = jax.random.PRNGKey(3)

    def draws(key):
        def one(k):
            kp, ke = jax.random.split(k)
            p = ja._sample_params(kp, jcfg)
            kx, ky = jax.random.split(ke)
            p["noise"] = jnp.stack([
                jax.random.uniform(kx, (H, W), minval=-1.0, maxval=1.0),
                jax.random.uniform(ky, (H, W), minval=-1.0, maxval=1.0)])
            return p
        return jax.vmap(one)(jax.random.split(key, B))

    def pre_tail(key):
        sy, sx, g, al, be = jax.vmap(lambda k: ja._coords_one(k, H, W, jcfg))(
            jax.random.split(key, B))
        img, mask = ja._warp_pair_batch(jnp.asarray(imgs, jnp.float32),
                                        jnp.asarray(msks, jnp.float32), sy, sx)
        img = ja._apply_intensity(img, g[:, None, None], al[:, None, None],
                                  be[:, None, None])
        return (jnp.round(img).astype(jnp.uint8),
                (mask > 127).astype(jnp.uint8), sy, sx)

    params = {k: torch.from_numpy(np.array(v))
              for k, v in jax.jit(draws)(key).items()}
    x, y = ja.augment_batch(key, imgs, msks, jcfg, train=True)
    ex, ey = ja.augment_batch(key, imgs, msks, jcfg, train=False)
    return dict(imgs=imgs, msks=msks, params=params,
                pre=[np.asarray(a) for a in jax.jit(pre_tail)(key)],
                x=np.asarray(x)[..., 0], y=np.asarray(y)[..., 0],
                ex=np.asarray(ex)[..., 0], ey=np.asarray(ey)[..., 0])


def test_augment_body_given_jax_draws_matches_jax(aug_case):
    """JAX's sampled parameters and elastic noise through the port's body.
    The source coordinates agree to f32 rounding (cos / sin and the smoothing
    sums: 2e-5 px); the warped, gamma- and contrast-mapped u8 image equals
    JAX's except where such a rounding crosses a .5 (at most 3 pixels of
    12288, by one grey level: here 1); the masks are equal."""
    p = aug_case["params"]
    cfg = AugmentConfig(**AUG_KW)
    table = ta.image_transforms(p, H, W)
    sy, sx = ta.warp_coords(table, p["noise"], cfg)
    ju8, jm8, jsy, jsx = aug_case["pre"]
    np.testing.assert_allclose(sy.numpy(), jsy, rtol=0, atol=1e-4)
    np.testing.assert_allclose(sx.numpy(), jsx, rtol=0, atol=1e-4)
    img, mask = ta.warp_pair_batch(torch.from_numpy(aug_case["imgs"]).float(),
                                   torch.from_numpy(aug_case["msks"]).float(),
                                   sy, sx)
    img = ta.apply_intensity(img, *[table[:, i, None, None] for i in (6, 7, 8)])
    u8 = torch.round(img).to(torch.uint8).numpy()
    off = np.abs(u8.astype(int) - ju8.astype(int))
    assert off.max() <= 1 and int((off > 0).sum()) <= 3, int((off > 0).sum())
    np.testing.assert_array_equal((mask > 127).to(torch.uint8).numpy(), jm8)

    x, y = ta.augment_batch(torch.from_numpy(aug_case["imgs"]),
                            torch.from_numpy(aug_case["msks"]), cfg, p)
    np.testing.assert_array_equal(y[:, 0].numpy(), aug_case["y"])
    # after CLAHE + median-3: a pixel off by one before CLAHE moves its
    # tile's histogram; at most 1 % of the pixels, by one grey level
    dx = np.abs(x[:, 0].numpy() - aug_case["x"]) * 255
    assert dx.max() <= 1.0 + 1e-4 and (dx > 1e-4).mean() <= 0.01


def test_augment_eval_path_is_bit_exact(aug_case):
    x, y = ta.augment_batch(torch.from_numpy(aug_case["imgs"]),
                            torch.from_numpy(aug_case["msks"]),
                            AugmentConfig(**AUG_KW), train=False)
    np.testing.assert_array_equal(x[:, 0].numpy(), aug_case["ex"])
    np.testing.assert_array_equal(y[:, 0].numpy(), aug_case["ey"])


def test_augment_without_clahe_and_noop_config(aug_case):
    """``use_clahe=False`` keeps only median-3 in the tail; with every
    transform off the train path equals the eval path."""
    imgs, msks = (torch.from_numpy(aug_case[k]) for k in ("imgs", "msks"))
    gen = torch.Generator().manual_seed(0)
    off = AugmentConfig(hflip_p=0, affine_p=0, gamma_p=0,
                        brightness_contrast_p=0, elastic_p=0)
    p = ta.sample_params(gen, B, H, W, off)
    x, _ = ta.augment_batch(imgs, msks, off, p, train=True)
    xe, _ = ta.augment_batch(imgs, msks, off, train=False)
    np.testing.assert_array_equal(x.numpy(), xe.numpy())
    nc = dataclasses.replace(off, use_clahe=False)
    x, _ = ta.augment_batch(imgs, msks, nc, train=False)
    jx, _ = ja.augment_batch(jax.random.PRNGKey(0), aug_case["imgs"],
                             aug_case["msks"],
                             JAugmentConfig(use_clahe=False), train=False)
    np.testing.assert_array_equal(x[:, 0].numpy(), np.asarray(jx)[..., 0])


def test_sample_params_distributions():
    """The port draws the JAX package's distributions (not its numbers):
    Bernoulli rates and uniform ranges over 4000 images, 4 sigma."""
    cfg = AugmentConfig()
    p = ta.sample_params(torch.Generator().manual_seed(1), 4000, 4, 4, cfg)
    n = 4000
    for key, rate in (("do_flip", cfg.hflip_p), ("do_affine", cfg.affine_p),
                      ("do_gamma", cfg.gamma_p),
                      ("do_bc", cfg.brightness_contrast_p),
                      ("do_elastic", cfg.elastic_p)):
        assert abs(p[key].float().mean().item() - rate) < \
            4 * np.sqrt(rate * (1 - rate) / n), key
    for key, lo, hi in (("scale", *cfg.scale_range),
                        ("angle", -np.deg2rad(cfg.rotate_deg),
                         np.deg2rad(cfg.rotate_deg)),
                        ("tx", -cfg.translate_frac, cfg.translate_frac),
                        ("gamma", *cfg.gamma_range),
                        ("brightness", -cfg.brightness_limit,
                         cfg.brightness_limit)):
        v = p[key].double()
        assert lo - 1e-6 <= v.min() and v.max() <= hi + 1e-6, key
        assert abs(v.mean().item() - (lo + hi) / 2) < 4 * (hi - lo) / np.sqrt(12 * n)
    assert p["noise"].shape == (4000, 2, 4, 4)
    assert -1.0 <= p["noise"].min() and p["noise"].max() < 1.0


# --- data -------------------------------------------------------------------

def test_data_pipeline_gives_jax_order(tmp_path, rng):
    """``collect_pairs`` (with and without a mask dir), the positive-only
    split and ``epoch_batches`` give the JAX package's files and order;
    ``from_paths`` the same uint8 arrays (PIL resize)."""
    for sub in ("images", "masks"):
        (tmp_path / sub).mkdir()
    for i in range(11):
        img = (rng.random((20, 24)) * 255).astype(np.uint8)
        write_gray_png(tmp_path / "images" / f"s{i:02d}.png", img)
        if i % 3:
            write_gray_png(tmp_path / "masks" / f"s{i:02d}.png", img > 128)
    got = tdata.collect_pairs(tmp_path / "images", tmp_path / "masks")
    want = jdata.collect_pairs(tmp_path / "images", tmp_path / "masks")
    assert got == want
    assert tdata.collect_pairs(tmp_path / "images", None) == \
        jdata.collect_pairs(tmp_path / "images", None)
    split_t = tdata.positive_only_val_split(*got, seed=2025)
    split_j = jdata.positive_only_val_split(*want, seed=2025)
    assert split_t == split_j
    dt = tdata.ArrayDataset.from_paths(*split_t[0], 16)
    dj = jdata.ArrayDataset.from_paths(*split_j[0], 16)
    for a in ("images", "masks", "is_positive"):
        np.testing.assert_array_equal(getattr(dt, a), getattr(dj, a))
    for epoch in (1, 2):
        for kw in ({}, dict(shuffle=False, drop_last=False)):
            bt = list(tdata.epoch_batches(dt, 3, 2025, epoch, **kw))
            bj = list(jdata.epoch_batches(dj, 3, 2025, epoch, **kw))
            assert len(bt) == len(bj)
            for (it, mt), (ij, mj) in zip(bt, bj):
                np.testing.assert_array_equal(it, ij)
                np.testing.assert_array_equal(mt, mj)


# --- schedule and optimizer -------------------------------------------------

@pytest.mark.parametrize("stage", ["main", "finetune"])
@pytest.mark.parametrize("epochs,spe", [(20, 10), (7, 13), (120, 3)])
def test_lr_schedule_matches_optax(stage, epochs, spe):
    """Every step of the run and a few past its end.  The port evaluates
    optax's f32 formulas in numpy f32; XLA's cos and its fused arithmetic
    differ in the last place on some steps: rtol 1e-6, and near the end of
    the cosine, where 1 + cos cancels, atol 1e-7 lr (one f32 ulp of cos is
    0.3e-7 lr there)."""
    kw = dict(epochs=epochs, lr=3e-4, stage=stage)
    js = jtl.make_lr_schedule(JTrainConfig(**kw), spe)
    ts = ttl.make_lr_schedule(TrainConfig(**kw), spe)
    n = epochs * spe + 3
    want = np.asarray(jax.vmap(js)(jnp.arange(n, dtype=jnp.int32)))
    got = np.array([ts(k) for k in range(n)], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * 3e-4)
    assert got[0] == pytest.approx(3e-4 if stage == "finetune" else 6e-5,
                                   rel=1e-6)


@pytest.mark.parametrize("differential", [False, True])
def test_adamw_updates_match_optax(differential):
    """Three updates with the same numpy gradients (the second large enough
    to clip, by the global norm of each group under the differential
    learning rate): parameters within 1e-6 of each leaf's max-abs of
    optax's; the labels are the JAX package's."""
    cfg = ModelConfig(base_c=4, compute_dtype="float32")
    v = init_variables(cfg, 0)
    jt = JTrainConfig(epochs=3, lr=1e-2, differential_lr=differential)
    tx = jtl.make_optimizer(jt, 2, v["params"])
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = tx.init(params)
    model = jax_variables_to_train_model(v, cfg)
    opt = ttl.make_optimizer(TrainConfig(epochs=3, lr=1e-2,
                                         differential_lr=differential), 2,
                             model)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(1)
    for scale in (0.01, 1.0, 0.05):
        g = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * scale).astype(
                np.float32), v["params"])
        upd, state = update(jax.tree_util.tree_map(jnp.asarray, g), state,
                            params)
        params = optax.apply_updates(params, upd)
        flat = {}

        def put(path, a):
            keys = tuple(str(p.key) for p in path)
            flat[".".join(keys)] = torch.from_numpy(
                np.ascontiguousarray(_leaf_to_torch(keys, np.asarray(a))))

        jax.tree_util.tree_map_with_path(put, g)
        opt.step([flat[n] for n in opt.names])
    got = torch_tensors_to_jax(dict(model.named_parameters()), cfg)["params"]

    def check(path, want, have):
        want = np.asarray(want)
        assert np.abs(want - have).max() <= 1e-6 * np.abs(want).max(), \
            jax.tree_util.keystr(path)

    jax.tree_util.tree_map_with_path(check, params, got)
    assert opt.count == 3
    if differential:
        labels = jax.tree_util.tree_map_with_path(
            lambda path, _: "att" if jtl._is_attention_param(path)
            else "backbone", v["params"])
        want = {}
        jax.tree_util.tree_map_with_path(
            lambda path, lab: want.__setitem__(
                ".".join(str(p.key) for p in path), lab), labels)
        (m_att, att), (m_bb, backbone) = opt.groups
        assert (m_att, m_bb) == (1.0, 0.5)
        got = {opt.names[i]: "att" for i in att}
        got.update({opt.names[i]: "backbone" for i in backbone})
        assert got == want
        assert set(want.values()) == {"att", "backbone"}
