"""The port's nnU-Net baseline path against the JAX package on the CPU, at a
small size (base 4 features capped at 16, 3 stages, 32 x 32 patches, as the
JAX package's own baseline parity test): the PlainConvUNet forward, the tile
grid and its Gaussian weight, sliding-window inference, the 3-D
largest-component postprocess, the class-aware frame ladder, the nnU-Net
importer, the flax converter, ``container.run`` with ``MODEL_TAG`` unset and
the ``infer-container`` command line.

Inputs are drawn from numpy seeds; the JAX references are computed once per
module.  Tolerances: f32 logits and softmax atol 1e-4; bf16 logits as
``test_forward_matches_flax`` states; labels, frames and the written
volumes are compared exactly."""

import dataclasses
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from att_aspp_unet_tpu.config import Config as JConfig
from att_aspp_unet_tpu.config import ContainerConfig as JContainerConfig
from att_aspp_unet_tpu.config import PlainUNetConfig as JPlainUNetConfig
from att_aspp_unet_tpu.infer import container as jcontainer
from att_aspp_unet_tpu.models import PlainConvUNet as JPlainConvUNet
from att_aspp_unet_tpu.models import sliding_window as jsw
from att_aspp_unet_tpu.postprocess import cc as jcc
from att_aspp_unet_tpu.postprocess.refine import \
    postprocess_softmax_stack as j_postprocess
from att_aspp_unet_tpu.utils import nnunet_import as jimport
from att_aspp_unet_tpu.utils.npz_weights import \
    load_npz_variables as jload_npz_variables
from att_aspp_unet_tpu.utils.npz_weights import save_npz_variables
from att_aspp_unet_tpu_torch import cli
from att_aspp_unet_tpu_torch.config import Config, ContainerConfig, \
    PlainUNetConfig
from att_aspp_unet_tpu_torch.infer import container as tcontainer
from att_aspp_unet_tpu_torch.io import MetaImage, read_json, read_mha, \
    write_mha
from att_aspp_unet_tpu_torch.models import PlainConvUNet
from att_aspp_unet_tpu_torch.models import sliding_window as tsw
from att_aspp_unet_tpu_torch.postprocess import cc as tcc
from att_aspp_unet_tpu_torch.postprocess.refine import \
    postprocess_softmax_stack as t_postprocess
from att_aspp_unet_tpu_torch.utils import nnunet_import as timport
from att_aspp_unet_tpu_torch.utils.convert import jax_plain_unet_to_torch
from att_aspp_unet_tpu_torch.utils.npz_weights import load_npz_variables

from .test_nnunet_import import _NNUNetOracle, _rename
from .test_torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(base_c=4, max_c=16, n_stages=3, patch_size=(32, 32))
PLAN_DIR = (Path(__file__).resolve().parents[1] / "resources/nnUNet_results/"
            "Dataset300_ACOptimalSuboptimal/nnUNetTrainer__nnUNetPlans__2d")


def _quiet(*a):
    pass


def _jcfg(dtype="float32", **kw):
    return JPlainUNetConfig(**SMALL, compute_dtype=dtype, **kw)


def _tcfg(dtype="float32", **kw):
    return PlainUNetConfig(**SMALL, compute_dtype=dtype, **kw)


@pytest.fixture(scope="module")
def flax_vars():
    """A flax PlainConvUNet params tree with every leaf from a numpy
    generator: kernels ~ N(0, 1/fan_in), norm scales in [0.5, 1.5), biases
    ~ N(0, 0.1); the head's kernel is scaled by 4 so that class
    probabilities cross 0.5 and the postprocess has components to keep."""
    model = JPlainConvUNet.from_config(_jcfg())
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), train=False))
    rng = np.random.default_rng(5)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "scale":
            return (rng.random(s.shape) + 0.5).astype(np.float32)
        if name == "bias":
            return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        gain = 4.0 if str(path[-2].key) == "seg_head" else 1.0
        return (gain * rng.standard_normal(s.shape)
                / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_apply(dtype):
    return functools.partial(JPlainConvUNet.from_config(_jcfg(dtype)).apply,
                             train=False)


def _sweep(seed, n, h, w):
    """Speckle with a bright ellipse per frame."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    out = (rng.random((n, h, w)) * 150).astype(np.uint8)
    for i in range(n):
        e = ((yy - 0.5 * h) / (0.3 * h)) ** 2 + \
            ((xx - (0.4 + 0.05 * i) * w) / (0.3 * w)) ** 2 <= 1
        out[i][e] = 240
    return out


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_flax(flax_vars, dtype):
    """f32: atol 1e-4.  bf16: both models round every conv, norm and
    activation output to bf16, in different summation orders, and each lies
    about 2 % of the largest logit from the f32 forward; the two bf16
    forwards must agree to 3 % of the largest |f32 logit| at every output
    and to 0.5 % of it on average."""
    x = np.random.default_rng(1).random((2, 1, 32, 64)).astype(np.float32)

    def flax_logits(dt):
        return np.asarray(_jax_apply(dt)(flax_vars, jnp.asarray(
            x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)

    vnp = jax.tree_util.tree_map(np.asarray, flax_vars)
    got = jax_plain_unet_to_torch(vnp, _tcfg(dtype))(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 3, 32, 64)
    want = flax_logits(dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
        return
    scale = float(np.abs(flax_logits("float32")).max())
    err = np.abs(got.numpy() - want)
    assert err.max() <= 0.03 * scale and err.mean() <= 0.005 * scale


def test_jax_plain_unet_to_torch_from_a_flax_init_and_an_npz(tmp_path):
    """A flax ``init`` tree, and the same tree through a flat-npz archive
    (which stores f16), give the port the flax model's logits; the port's
    parameters carry nnU-Net v2's names."""
    model = JPlainConvUNet.from_config(_jcfg())
    variables = jax.jit(lambda: model.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 1)), train=False))()
    apply = jax.jit(lambda v, x: model.apply(v, x, train=False))
    x = np.random.default_rng(2).random((3, 32, 32, 1)).astype(np.float32)
    save_npz_variables(variables, tmp_path / "w.npz")
    for tree, vnp in (
            (variables, jax.tree_util.tree_map(np.asarray, variables)),
            (jload_npz_variables(tmp_path / "w.npz"),
             load_npz_variables(tmp_path / "w.npz"))):
        want = np.asarray(apply(tree, jnp.asarray(x))).transpose(0, 3, 1, 2)
        port = jax_plain_unet_to_torch(vnp, _tcfg())
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    names = set(port.state_dict())
    assert {"encoder.stages.0.0.convs.0.conv.weight",
            "encoder.stages.2.0.convs.1.norm.bias",
            "decoder.transpconvs.1.weight",
            "decoder.stages.1.convs.0.norm.weight",
            "decoder.seg_layers.1.bias"} <= names
    assert not any(k.startswith("decoder.seg_layers.0") for k in names)


# ------------------------------------------------------- sliding window

@pytest.mark.parametrize("image,tile,step", [
    (9, 4, 1.0),           # starts 0, 2.5 -> 2 (half to even), 5
    (562, 448, 0.5), (744, 576, 0.5), (448, 448, 0.5), (300, 448, 0.5),
    (1000, 448, 0.5), (95, 32, 0.5), (56, 32, 0.5)])
def test_compute_tile_starts_equals_jax(image, tile, step):
    got = tsw.compute_tile_starts(image, tile, step)
    assert got == jsw.compute_tile_starts(image, tile, step)
    if image == 9:
        assert got == [0, 2, 5]
    if (image, tile) in ((562, 448), (744, 576)):
        assert got == [0, image - tile]


@pytest.mark.parametrize("hw", [(448, 576), (32, 32), (31, 17)])
def test_gaussian_importance_map_equals_jax(hw):
    got = tsw.gaussian_importance_map(hw)
    want = jsw.gaussian_importance_map(hw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# (frames shape, use_gaussian, use_mirroring, mirror_batch, tile_batch):
# 40 x 56 frames have 2 x 3 tiles, so N * T = 18 is no multiple of 5 or 4;
# frames smaller than the patch in one or both sides are padded
SW_CASES = [((3, 40, 56), True, True, True, 5),
            ((3, 40, 56), True, True, False, 4),
            ((3, 40, 56), False, False, False, 7),
            ((2, 20, 27), True, True, True, 3),
            ((2, 29, 45), True, True, False, 3)]


@pytest.fixture(scope="module")
def sw_refs(flax_vars):
    """The JAX ``sliding_window_predict`` of every case of SW_CASES."""
    apply = _jax_apply("float32")
    refs = []
    for k, (shape, gauss, mirror, mbatch, tb) in enumerate(SW_CASES):
        frames = np.random.default_rng(10 + k).random(shape).astype(np.float32)
        refs.append((frames, np.asarray(jsw.sliding_window_predict(
            apply, flax_vars, jnp.asarray(frames), (32, 32), 0.5, gauss,
            mirror, tb, mbatch))))
    return refs


@pytest.mark.parametrize("case", range(len(SW_CASES)))
def test_sliding_window_predict_matches_jax(flax_vars, sw_refs, case):
    _, gauss, mirror, mbatch, tb = SW_CASES[case]
    frames, want = sw_refs[case]
    model = jax_plain_unet_to_torch(
        jax.tree_util.tree_map(np.asarray, flax_vars), _tcfg())
    got = tsw.sliding_window_predict(model, torch.from_numpy(frames),
                                     (32, 32), 0.5, gauss, mirror, tb, mbatch)
    assert got.shape == want.shape == (frames.shape[0], 3) + frames.shape[1:]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # the classes sum to one at every pixel, padding cropped away
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-5)


# ---------------------------------------------------------- postprocess

def _serpentine(rows: int, width: int) -> np.ndarray:
    """A one-pixel snake: every other row full, joined at alternating ends,
    so that labels cross it one bend per propagation iteration."""
    m = np.zeros((rows, width), bool)
    m[::2] = True
    for r in range(1, rows, 2):
        m[r, width - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


def _stack_from_labels(lab: np.ndarray) -> np.ndarray:
    """A (3, N, H, W) softmax stack whose thresholded argmax is ``lab``:
    0.8 on the pixel's class, 0.1 on the others."""
    sm = np.full((3,) + lab.shape, 0.1, np.float32)
    for c in range(3):
        sm[c][lab == c] = 0.8
    return sm


def _softmax_cases():
    rng = np.random.default_rng(7)
    # blobs: coarse random logits, upsampled, with a little noise
    coarse = rng.standard_normal((3, 4, 6, 8)) * 2.0
    logits = np.repeat(np.repeat(coarse, 4, axis=2), 4, axis=3) + \
        rng.standard_normal((3, 4, 24, 32)) * 0.3
    e = np.exp(logits - logits.max(0))
    blobs = (e / e.sum(0)).astype(np.float32)
    # two class-1 components of 27 voxels each (the first by flat index must
    # win), one class-2 component
    ties = np.zeros((4, 12, 12), np.uint8)
    ties[2:5, 1:4, 1:4] = 1
    ties[0:3, 8:11, 8:11] = 1
    ties[1, 5:7, 5:7] = 2
    # a snake in frame 0 and another in frame 2 (44 pixels each), joined
    # only through one pixel of frame 1, against a 60-voxel block; a small
    # class-2 region
    snake = np.zeros((3, 16, 16), np.uint8)
    s = _serpentine(9, 8)
    snake[0, :9, :8] = s
    snake[2, :9, :8] = s[:, ::-1]
    snake[1, 8, 0] = 1
    snake[:, 11:15, 10:15] = 1
    snake[1, 11:13, 0:3] = 2
    # a snake of 131 bends in one frame: the propagation stops at its cap
    # of 128 iterations before the smallest label has crossed it
    capped = _serpentine(263, 6)[None].astype(np.uint8)
    return {"blobs": blobs, "ties": _stack_from_labels(ties),
            "snake": _stack_from_labels(snake),
            "capped": _stack_from_labels(capped),
            "empty": np.full((3, 2, 8, 8), 1.0 / 3, np.float32)}


SOFTMAX_CASES = _softmax_cases()


@pytest.mark.parametrize("name", sorted(SOFTMAX_CASES))
def test_postprocess_softmax_stack_bit_exact(name):
    sm = SOFTMAX_CASES[name]
    want = np.asarray(j_postprocess(jnp.asarray(sm), 0.5))
    got = t_postprocess(torch.from_numpy(sm), 0.5)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "empty":
        assert not want.any()
    if name == "snake":
        # the joined snakes (89 pixels) beat the 60-voxel block
        assert int((want == 1).sum()) == 89 and int((want == 2).sum()) == 6
    if name == "ties":
        assert int((want == 1).sum()) == 27 and want[0, 8, 8] == 1
    for lab in (1, 2):
        fg = SOFTMAX_CASES[name].argmax(0) == lab
        got_l = tcc.label_components(torch.from_numpy(fg), 6, ndim=3)
        want_l = np.asarray(jcc.label_components(jnp.asarray(fg), 6, 3))
        np.testing.assert_array_equal(got_l.numpy(), want_l)


def test_labels_stop_at_the_iteration_cap():
    """The capped snake is still in pieces after 128 iterations, in the
    port as in the JAX package; without the cap it is one component."""
    fg = SOFTMAX_CASES["capped"].argmax(0) == 1
    capped = tcc.label_components(torch.from_numpy(fg), 6, ndim=3)
    full = tcc.label_components(torch.from_numpy(fg), 6, max_iters=1000,
                                ndim=3)
    assert len(torch.unique(capped)) > 2 and len(torch.unique(full)) == 2


@pytest.mark.parametrize("name,frame,area", [
    ("class-2 frame wins", 1, 12),
    ("class 1 is checked first", 1, 8),
    ("empty", -1, 0)])
def test_select_labeled_mask_and_frame_equals_jax(name, frame, area):
    """The JAX tests' ladder cases (``tests/test_infer.py``)."""
    if name == "class-2 frame wins":
        seg = np.zeros((3, 8, 8), np.uint8)
        seg[0, :2, :2] = 1
        seg[1, :3, :4] = 2
    elif name == "class 1 is checked first":
        seg = np.zeros((2, 8, 8), np.uint8)
        seg[0, 0, :5] = 1            # a1 = 5 wins frame 0, a2 is skipped
        seg[0, 1:6, :4] = 2          # a2 = 20, never consulted
        seg[1, :2, :4] = 2           # a2 = 8 > 5 takes the frame
    else:
        seg = np.zeros((2, 4, 4), np.uint8)
    m, f = tcontainer.select_labeled_mask_and_frame(torch.from_numpy(seg))
    jm, jf = jcontainer.select_labeled_mask_and_frame(seg)
    assert f == jf == frame and int(m.sum()) == area
    assert m.dtype == np.uint8
    np.testing.assert_array_equal(m, jm)


# ------------------------------------------------------ nnU-Net import

@pytest.fixture(scope="module")
def oracle():
    """The JAX tests' nnU-Net v2 PlainConvUNet oracle (torch, nnunetv2's
    names after ``_rename``) with random weights and affine norms."""
    torch.manual_seed(4)
    net = _NNUNetOracle(_jcfg())
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.InstanceNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0.0, 0.1)
    return net.eval()


def test_nnunet_import_gives_the_oracle_and_the_jax_model(oracle):
    sd = _rename({k: v.detach().numpy() for k, v in
                  oracle.state_dict().items()})
    port = timport.nnunet_state_dict_to_torch(sd, _tcfg(), verbose=False)
    jmodel = JPlainConvUNet.from_config(_jcfg())
    jvars = jimport.convert_nnunet_state_dict(
        sd, _jcfg(), jax.jit(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), train=False))(),
        verbose=False)
    x = torch.from_numpy(np.random.default_rng(3).random(
        (2, 1, 32, 32)).astype(np.float32))
    got = port(x).numpy()
    with torch.no_grad():
        want = oracle(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    want_j = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jvars, jnp.asarray(x.numpy().transpose(0, 2, 3, 1)))).transpose(
            0, 3, 1, 2)
    np.testing.assert_allclose(got, want_j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("container,prefix", [
    ("network_weights", "module."), ("state_dict", "_orig_mod."),
    (None, ""), ("network_weights", "")])
def test_load_nnunet_checkpoint_containers_and_prefixes(oracle, tmp_path,
                                                        capsys, container,
                                                        prefix):
    """A ``.pth`` in each container, with each prefix, and with the
    deep-supervision head and a ``num_batches_tracked`` entry beside the
    weights: all keys found, none unexpected, the oracle's logits."""
    sd = {prefix + k: v for k, v in _rename(oracle.state_dict()).items()}
    assert prefix + "decoder.seg_layers.0.weight" in sd
    sd[prefix + "encoder.stages.0.0.convs.0.norm.num_batches_tracked"] = \
        torch.tensor(0)
    obj = {container: sd, "trainer_name": "nnUNetTrainer"} if container \
        else sd
    torch.save(obj, tmp_path / "checkpoint_final.pth")
    port = timport.load_nnunet_checkpoint(tmp_path / "checkpoint_final.pth",
                                          _tcfg())
    assert "loaded with 0 missing & 0 unexpected keys" in capsys.readouterr().out
    x = torch.rand(1, 1, 32, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        np.testing.assert_allclose(port(x).numpy(), oracle(x).numpy(),
                                   rtol=0, atol=2e-4)
    assert list(timport.normalize_nnunet_state_dict(obj)) == \
        list(jimport.normalize_nnunet_state_dict(obj))


def test_load_plans_config_in_repo_plan_equals_jax():
    got = timport.load_plans_config(PLAN_DIR / "plans.json",
                                    dataset_json=PLAN_DIR / "dataset.json")
    want = jimport.load_plans_config(PLAN_DIR / "plans.json",
                                     dataset_json=PLAN_DIR / "dataset.json")
    fields = {f.name for f in dataclasses.fields(got)}
    assert fields == {f.name for f in dataclasses.fields(want)} \
        - {"conv_lowering"}
    assert {k: getattr(want, k) for k in fields} == dataclasses.asdict(got)
    assert (got.base_c, got.max_c, got.n_stages, got.patch_size,
            got.num_classes) == (32, 512, 7, (448, 576), 3)


def test_load_plans_config_rejects_what_it_cannot_build(tmp_path):
    plans = tmp_path / "plans.json"
    plans.write_text(json.dumps({"configurations": {"2d": {
        "UNet_class_name": "ResEncUNet", "n_conv_per_stage_encoder": [2, 2],
        "patch_size": [64, 64], "UNet_base_num_features": 16}}}))
    for mod in (timport, jimport):
        with pytest.raises(ValueError, match="ResEncUNet"):
            mod.load_plans_config(plans)
        with pytest.raises(KeyError):
            mod.load_plans_config(plans, configuration="3d_fullres")


# ---------------------------------------------------- container and CLI

def _case_tree(root, sweep):
    d = root / "input/images/stacked-fetal-ultrasound"
    d.mkdir(parents=True)
    write_mha(d / "case-0002_0000.mha",
              MetaImage(sweep, spacing=(0.28, 0.28, 0.28)))


def _check_contract(out: Path, case: str, shape):
    vol = read_mha(out / f"images/fetal-abdomen-segmentation/{case}.mha")
    frame = read_json(out / "fetal-abdomen-frame-number.json")
    arr = vol.array
    assert arr.shape == shape and arr.dtype == np.uint8
    assert set(np.unique(arr)) <= {0, 1}
    assert vol.spacing == pytest.approx((0.28, 0.28, 0.28))
    fg = np.flatnonzero(arr.reshape(shape[0], -1).any(axis=1)).tolist()
    assert fg == ([frame] if frame >= 0 else [])
    return frame, arr


def test_container_run_default_model_matches_jax_run(flax_vars, tmp_path,
                                                     monkeypatch):
    """``run_from_env`` with ``MODEL_TAG`` unset serves the baseline in both
    packages: the same files, the same frame JSON, equal volumes, the
    probability dumps at atol 1e-4, the debug PNGs byte for byte."""
    sweep = _sweep(3, 3, 40, 56)
    _case_tree(tmp_path, sweep)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("MODEL_TAG", raising=False)
    monkeypatch.setenv("CASE_ID", "case7")
    vnp = jax.tree_util.tree_map(np.asarray, flax_vars)
    outs = {}
    for name, mod, c, v, extra in (
            ("jax", jcontainer, JConfig(plain_unet=_jcfg()), flax_vars, {}),
            ("port", tcontainer, Config(plain_unet=_tcfg()), vnp,
             {"device": "cpu"})):
        ccls = JContainerConfig if name == "jax" else ContainerConfig
        c = dataclasses.replace(c, container=ccls(
            input_path=str(tmp_path / "input"),
            output_path=str(tmp_path / name)))
        assert c.container.model_tag == "baseline"
        assert mod.run_from_env(c, v, log=_quiet, **extra) == 0
        prob = tmp_path / "output/probabilities/case-0002_0000_prob.npy"
        outs[name] = np.load(prob)
        prob.unlink()
    assert outs["port"].shape == (3, 3, 40, 56)
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=0, atol=1e-4)
    files = {n: sorted(str(p.relative_to(tmp_path / n))
                       for p in (tmp_path / n).rglob("*") if p.is_file())
             for n in ("jax", "port")}
    assert files["port"] == files["jax"] and len(files["port"]) == 8
    frame, got = _check_contract(tmp_path / "port", "case7", sweep.shape)
    assert frame >= 0 and frame == read_json(
        tmp_path / "jax/fetal-abdomen-frame-number.json")
    np.testing.assert_array_equal(
        got, read_mha(tmp_path / "jax/images/fetal-abdomen-segmentation/"
                      "case7.mha").array)
    for png in ("frame000_orig.png", "frame001_enh.png"):
        assert (tmp_path / "port/images" / png).read_bytes() == \
            (tmp_path / "jax/images" / png).read_bytes()


def _small_plans(tmp_path) -> Path:
    plans = tmp_path / "plans.json"
    plans.write_text(json.dumps({"configurations": {"2d": {
        "UNet_class_name": "PlainConvUNet", "UNet_base_num_features": 4,
        "unet_max_num_features": 16, "n_conv_per_stage_encoder": [2, 2, 2],
        "conv_kernel_sizes": [[3, 3]] * 3,
        "pool_op_kernel_sizes": [[1, 1], [2, 2], [2, 2]],
        "patch_size": [32, 32]}}}))
    return plans


@pytest.mark.parametrize("weights", ["pth", "npz", "none"])
def test_cli_infer_container_baseline_weights(oracle, flax_vars, tmp_path,
                                              monkeypatch, capsys, weights):
    """``infer-container`` with no ``MODEL_TAG`` and the small plan: an
    nnU-Net ``.pth``, the JAX package's ``.npz`` or, without ``--weights``,
    the initialisation of seed 0; the written case equals ``container.run`` of
    the model built directly."""
    sweep = _sweep(4, 2, 40, 56)
    _case_tree(tmp_path, sweep)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("MODEL_TAG", raising=False)
    monkeypatch.delenv("CASE_ID", raising=False)
    cfg = PlainUNetConfig(**SMALL)                       # bf16, as the CLI
    argv = ["infer-container", "--input", str(tmp_path / "input"),
            "--output", str(tmp_path / "cli"), "--plans",
            str(_small_plans(tmp_path)), "--dataset-json",
            str(PLAN_DIR / "dataset.json"), "--device", "cpu",
            "--no-save-probabilities", "--no-debug-frames"]
    if weights == "pth":
        torch.save({"network_weights": _rename(oracle.state_dict())},
                   tmp_path / "ckpt.pth")
        argv += ["--weights", str(tmp_path / "ckpt.pth")]
        model = timport.nnunet_state_dict_to_torch(
            _rename(oracle.state_dict()), cfg, verbose=False)
        said = "loaded with 0 missing & 0 unexpected keys"
    elif weights == "npz":
        save_npz_variables(flax_vars, tmp_path / "w.npz")
        argv += ["--weights", str(tmp_path / "w.npz")]
        model = jax_plain_unet_to_torch(load_npz_variables(tmp_path / "w.npz"),
                                        cfg)
        said = ""
    else:
        model = PlainConvUNet.from_config(cfg, seed=0)
        said = "[warn] no --weights given: using random init (smoke mode)"
    assert cli.main(argv) == 0
    assert said in capsys.readouterr().out
    frame, got = _check_contract(tmp_path / "cli", "output", sweep.shape)
    c = Config(plain_unet=cfg, container=ContainerConfig(
        input_path=str(tmp_path / "input"), output_path=str(tmp_path / "run")))
    tcontainer.run(c, model, save_probabilities=False, debug_frames=False,
                   device="cpu", log=_quiet)
    want_frame, want = _check_contract(tmp_path / "run", "output", sweep.shape)
    assert frame == want_frame
    np.testing.assert_array_equal(got, want)
