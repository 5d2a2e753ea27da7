"""Port parity: image ops, CLAHE and the enhance chain (torch on the CPU vs
the JAX package's default XLA path), and the plain version of kernel K2 vs
the JAX Pallas kernel in interpret mode."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from att_aspp_unet_tpu.ops import image as jimage
from att_aspp_unet_tpu.ops.pallas.clahe_interp import (
    clahe_interp_pallas, clahe_interp_pallas_batched)
from att_aspp_unet_tpu.preprocess import enhance as jenhance
from att_aspp_unet_tpu_torch.ops import image as timage
from att_aspp_unet_tpu_torch.ops.kernels.clahe_interp import (
    clahe_interp, clahe_interp_batched, clahe_interp_reference)
from att_aspp_unet_tpu_torch.preprocess import enhance as tenhance
from .test_torch_threads import one_torch_thread  # noqa: F401

# ``att_aspp_unet_tpu.ops.clahe`` the attribute is the function; the module:
jclahe = importlib.import_module("att_aspp_unet_tpu.ops.clahe")
tclahe = importlib.import_module("att_aspp_unet_tpu_torch.ops.clahe")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _frames(rng, n, h, w, dtype=np.uint8, hi=255):
    return (rng.random((n, h, w)) * hi).astype(dtype)


def test_minmax_normalize_u8_bit_exact(rng):
    x = rng.standard_normal((3, 17, 23)).astype(np.float32) * 40
    x[1] = 7.0                                      # constant frame -> 0
    # exact .5 ties after scaling: lo 0, hi 510 -> odd values land on .5
    x[2] = (rng.integers(0, 511, (17, 23))).astype(np.float32)
    x[2, 0, 0], x[2, 0, 1] = 0, 510
    want = np.asarray(jimage.minmax_normalize_u8(jnp.asarray(x)))
    got = timage.minmax_normalize_u8(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_median3x3_bit_exact(rng):
    x = _frames(rng, 2, 19, 26)
    want = np.asarray(jimage.median3x3(jnp.asarray(x)))
    np.testing.assert_array_equal(timage.median3x3(_t(x)).numpy(), want)


@pytest.mark.parametrize("ksize", [5, 7])
def test_gaussian_blur_matches(rng, ksize):
    x = rng.random((2, 21, 30)).astype(np.float32)
    want = np.asarray(jimage.gaussian_blur(jnp.asarray(x), ksize))
    got = timage.gaussian_blur(_t(x), ksize).numpy()
    # same taps summed in the same order: f32 rounding only
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("src,dst", [((37, 45), (32, 32)), ((32, 32), (37, 45)),
                                     ((57, 75), (51, 51)), ((51, 51), (57, 75))])
def test_resize_bilinear_matches_both_directions(rng, src, dst):
    """Down- and upscale at odd sizes.  A wrong border weight (clamped
    source coordinate vs jax's renormalised triangle) would be off by whole
    grey levels; what remains is f32 rounding of the source coordinate
    (~1e-5 at these coordinates) times the 0..255 value range, hence
    atol 2e-3, checked on the border rows and columns as well."""
    x = (rng.random((2,) + src) * 255).astype(np.float32)
    want = np.asarray(jimage.resize_bilinear(jnp.asarray(x), dst))
    got = timage.resize_bilinear(_t(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    for sl in ((Ellipsis, 0, slice(None)), (Ellipsis, -1, slice(None)),
               (Ellipsis, 0), (Ellipsis, -1)):
        np.testing.assert_allclose(got[sl], want[sl], rtol=0, atol=2e-3)


@pytest.mark.parametrize("shape,grid", [((2, 40, 48), (8, 8)),
                                        ((2, 45, 61), (8, 8)),
                                        ((1, 50, 37), (4, 6))])
def test_clahe_bit_exact(rng, shape, grid):
    """Includes REFLECT padding (45x61) and a non-square grid, where the
    cv2 (cols, rows) order matters."""
    x = _frames(rng, *shape)
    x[0, :8, :8] = 250                                   # clipped histogram
    want = np.asarray(jclahe.clahe(jnp.asarray(x), 1.0, grid))
    got = tclahe.clahe(_t(x), 1.0, grid).numpy()
    np.testing.assert_array_equal(got, want)


def test_enhance_and_preprocess_match(rng):
    x = (rng.random((3, 45, 61)) * 1000).astype(np.float32)
    want = np.asarray(jenhance.enhance_frames(jnp.asarray(x)))
    np.testing.assert_array_equal(tenhance.enhance_frames(_t(x)).numpy(), want)
    want_p = np.asarray(jenhance.preprocess_sweep(jnp.asarray(x), 32))
    got_p = tenhance.preprocess_sweep(_t(x), 32).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=1e-6, atol=1e-6)


def _interp_case(rng, N=2, B=6, P=64):
    blocks = (rng.random((N, B, P)) * 256).astype(np.int32)
    blocks[0, 0, :5] = -1                                # padding pixels
    luts = np.sort((rng.random((N, B, 256, 4)) * 255).round(), axis=2
                   ).astype(np.float32)
    wts = rng.random((P, 4)).astype(np.float32)
    wts = wts / wts.sum(axis=1, keepdims=True)
    return blocks, luts, wts


@pytest.mark.parametrize("jax_kernel", [clahe_interp_pallas,
                                        clahe_interp_pallas_batched])
def test_clahe_interp_plain_matches_pallas_and_gather(rng, jax_kernel):
    """The port's plain K2 (what the wrapper runs for CPU tensors) against
    both JAX Pallas kernels in interpret mode and the direct gather oracle
    (``tests/test_pallas_kernels.py``), rtol 1e-6 / atol 1e-5."""
    blocks, luts, wts = _interp_case(rng)
    got = clahe_interp(_t(blocks), _t(luts), _t(wts)).numpy()
    ref = np.asarray(jax_kernel(jnp.asarray(blocks), jnp.asarray(luts),
                                jnp.asarray(wts), interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    oracle = np.zeros_like(got)
    for n in range(blocks.shape[0]):
        for b in range(blocks.shape[1]):
            v = blocks[n, b]
            g = luts[n, b][np.clip(v, 0, 255)] * (v >= 0)[:, None]
            oracle[n, b] = (g * wts).sum(axis=1)
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-5)
    assert clahe_interp_batched is clahe_interp


def test_clahe_interp_plain_is_the_xla_blend(rng):
    """Bit-exact against the JAX default path's blend of the looked-up
    values (one-hot lookup, then ``sum(g * w, -1)``, which XLA evaluates as
    an FMA chain)."""
    blocks, luts, wts = _interp_case(rng, N=1, B=4, P=300)
    blocks = np.clip(blocks, 0, 255)
    want = np.asarray(jclahe._interp_blocks(
        jnp.asarray(blocks.astype(np.uint8)), jnp.asarray(luts),
        jnp.asarray(wts), "onehot_bf16"))
    got = clahe_interp_reference(_t(blocks), _t(luts), _t(wts)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((7, 10), (16, 23)), ((16, 23), (7, 10)), ((224, 224), (562, 744)),
    ((562, 744), (224, 224)), ((48, 48), (96, 128)), ((5, 9), (5, 4)),
    ((3, 3), (8, 8)), ((342, 544), (617, 854)), ((762, 208), (159, 707))])
def test_resize_nearest_bit_exact(rng, in_hw, out_hw):
    """Up- and downscales with non-integer ratios: the source pixel is
    ``floor((i + 0.5) * in / out)`` in f32 (half-pixel centres), which
    ``F.interpolate(mode="nearest")`` does not take."""
    x = rng.integers(0, 256, (2,) + in_hw).astype(np.uint8)
    want = np.asarray(jimage.resize_nearest(jnp.asarray(x), out_hw))
    got = timage.resize_nearest(_t(x), out_hw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    xf = x[0].astype(np.float32)
    np.testing.assert_array_equal(
        timage.resize_nearest(_t(xf), out_hw).numpy(),
        np.asarray(jimage.resize_nearest(jnp.asarray(xf), out_hw)))


def test_minmax_normalize_u8_takes_the_f32_stack_of_resize_bilinear(rng):
    """The cascade's low-resolution enhancement feeds ``minmax_normalize_u8``
    the f32 stack that ``resize_bilinear`` returns.  The two resizes differ
    by a few f32 ulp, so a value that lands on a rounding boundary may come
    out one grey level apart: at most 1, on at most 0.5 % of the pixels."""
    x = _frames(rng, 3, 96, 128)
    want = np.asarray(jimage.minmax_normalize_u8(jimage.resize_bilinear(
        jnp.asarray(x).astype(jnp.float32), (32, 32))))
    lo = timage.resize_bilinear(_t(x).float(), (32, 32))
    assert lo.dtype == torch.float32
    got = timage.minmax_normalize_u8(lo)
    assert got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 5e-3
