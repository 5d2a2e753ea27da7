"""Port parity of the exact mask ops, candidate ranking, frame selection and
AC measurement: bit-exact against the JAX package."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from att_aspp_unet_tpu.infer import engine as jengine
from att_aspp_unet_tpu.measure.ellipse import measure_ac_mm as j_measure
from att_aspp_unet_tpu.postprocess import cc as jcc
from att_aspp_unet_tpu.postprocess import morphology as jmorph
from att_aspp_unet_tpu.postprocess import refine as jrefine
from att_aspp_unet_tpu.postprocess import select as jselect
from att_aspp_unet_tpu.postprocess.select import \
    select_best_frame_exact as j_select
from att_aspp_unet_tpu_torch.infer import engine as tengine
from att_aspp_unet_tpu_torch.measure.ellipse import measure_ac_mm as t_measure
from att_aspp_unet_tpu_torch.postprocess import cc as tcc
from att_aspp_unet_tpu_torch.postprocess import morphology as tmorph
from att_aspp_unet_tpu_torch.postprocess import refine as trefine
from att_aspp_unet_tpu_torch.postprocess import select as tselect
from att_aspp_unet_tpu_torch.postprocess.select import \
    select_best_frame_exact as t_select
from .test_torch_threads import one_torch_thread  # noqa: F401


def _blobs(rng, n, h, w, density=0.55):
    """Speckled masks with rings, holes and specks: every op has work."""
    yy, xx = np.mgrid[:h, :w]
    out = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        r = np.hypot((yy - cy) / (0.3 * h), (xx - cx) / (0.35 * w))
        ring = (r > 0.6) & (r < 1.0)
        out[i] = ring | (rng.random((h, w)) > 1.5 * density) | \
            ((r < 0.3) & (rng.random((h, w)) > 0.5))
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("conn", [4, 8])
def test_label_components_bit_exact(rng, conn):
    m = (rng.random((3, 23, 31)) > 0.55).astype(np.uint8)
    want = np.asarray(jcc.label_components(jnp.asarray(m), conn, 2))
    got = tcc.label_components(_t(m), conn).numpy()
    np.testing.assert_array_equal(got, want)


def test_largest_component_and_fill_and_close_bit_exact(rng):
    m = _blobs(rng, 4, 37, 45)
    np.testing.assert_array_equal(
        tcc.largest_component(_t(m), 8, min_area=5).numpy(),
        np.asarray(jcc.largest_component(jnp.asarray(m), 8, 2, min_area=5)))
    np.testing.assert_array_equal(
        tmorph.fill_holes(_t(m)).numpy(),
        np.asarray(jmorph.fill_holes(jnp.asarray(m))))
    se = jmorph.structuring_ellipse(7)
    np.testing.assert_array_equal(tmorph.structuring_ellipse(7), se)
    np.testing.assert_array_equal(
        tmorph.binary_closing(_t(m), se).numpy(),
        np.asarray(jmorph.binary_closing(jnp.asarray(m), se)))


def test_refine_mask_bit_exact_all_variants(rng):
    """``refine_mask`` and the port's true-size stand-in for the JAX
    engine's bucket-padded refine agree exactly with theirs."""
    m = _blobs(rng, 4, 41, 53)
    m[3] = 0                                             # empty frame
    want = np.asarray(jrefine.refine_mask(jnp.asarray(m)))
    np.testing.assert_array_equal(trefine.refine_mask(_t(m)).numpy(), want)

    hb, wb = jrefine.refine_bucket_hw(41, 53)
    padded = np.pad(m, ((0, 0), (0, hb - 41), (0, wb - 53)))
    want_p = np.asarray(jrefine._refine_mask_padded(
        jnp.asarray(padded), jnp.asarray([41, 53], jnp.int32), 20, 0.0015,
        7))[:, :41, :53]
    np.testing.assert_array_equal(
        trefine.refine_mask_true_size(_t(m), 20, 0.0015, 7).numpy(), want_p)


@pytest.mark.parametrize("hw", [(40, 48), (42, 50), (41, 47)])
def test_candidate_rank_areas_bit_exact(rng, hw):
    """Includes sizes that are not multiples of 4, where the 4x4 "SAME" max
    pool pads (42 -> 1 row each side, 41/47 -> 1 low and 2 high)."""
    m = _blobs(rng, 5, *hw)
    want = np.asarray(jengine.candidate_rank_areas(jnp.asarray(m), 7))
    got = tengine.candidate_rank_areas(_t(m), 7).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_rank(areas, n_valid, n_cand):
    """The ranking lines of ``_predict_case_impl`` verbatim."""
    n = areas.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    a = jnp.where(idx < n_valid, jnp.asarray(areas, jnp.int32), -1)
    return np.asarray(jnp.lexsort((-idx, -a))[:n_cand])


@pytest.mark.parametrize("n_valid", [9, 6])
def test_rank_candidates_tie_order_and_n_valid(n_valid):
    areas = np.array([5, 9, 5, 0, 9, 7, 5, 9, 0], np.int64)   # ties everywhere
    got = tengine.rank_candidates(areas, n_valid, 7)
    np.testing.assert_array_equal(got, _jax_rank(areas, n_valid, 7))
    # higher frame index first on equal areas; padded frames rank last
    assert list(got[:3]) == ([7, 4, 1] if n_valid == 9 else [4, 1, 5])


def test_select_and_measure_equal_jax(rng):
    h, w = 60, 72
    yy, xx = np.mgrid[:h, :w]
    masks = []
    for i, (ry, rx) in enumerate([(14, 20), (16, 16), (10, 25), (16, 16),
                                  (12, 12), (2, 1)]):
        e = ((yy - 30) / ry) ** 2 + ((xx - 36) / rx) ** 2 <= 1
        if i == 2:
            e[25:35, 10:14] = 0                          # notch: less round
        masks.append(e.astype(np.uint8))
    masks = np.stack(masks)
    assert t_select(masks, 5) == j_select(masks, 5)
    for m in masks:
        for sp in [(0.28, 0.28), (0.2, 0.31)]:
            assert t_measure(m, sp) == j_measure(m, sp)
    two = masks[0] | np.roll(masks[4], 25, axis=1)       # two components
    assert t_measure(two, (0.28, 0.28)) == j_measure(two, (0.28, 0.28))
    assert t_measure(np.zeros((5, 5), np.uint8), (1, 1)) == 0.0


@pytest.mark.parametrize("hw", [(40, 48), (41, 47)])
def test_candidate_rank_areas_closed_only_bit_exact(rng, hw):
    """``fill_proxy=False``: the scout tier's closed-area key."""
    m = _blobs(rng, 5, *hw)
    want = np.asarray(jengine.candidate_rank_areas(jnp.asarray(m), 7,
                                                   fill_proxy=False))
    got = tengine.candidate_rank_areas(_t(m), 7, fill_proxy=False).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got <= tengine.candidate_rank_areas(_t(m), 7).numpy()).all()


@pytest.mark.parametrize("iterations", [1, 3])
def test_binary_dilation_iterations_bit_exact(rng, iterations):
    m = (rng.random((3, 21, 27)) > 0.93).astype(np.uint8)
    want = np.asarray(jmorph.binary_dilation(
        jnp.asarray(m), np.ones((3, 3), np.uint8), iterations=iterations))
    got = tmorph.binary_dilation(_t(m), iterations=iterations).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["blobs", "tie", "empty"])
def test_postprocess_roi_stack_and_select_max_area_bit_exact(rng, case):
    """Threshold 0.05, the max-area frame (the first on ties), one 3x3
    dilation, largest 8-connected component; the empty stack gives zeros and
    frame -1."""
    yy, xx = np.mgrid[:45, :57]
    prob = np.zeros((5, 45, 57), np.float32)
    if case != "empty":
        for i, r in enumerate([6, 11, 9, 11, 3]):
            blob = np.hypot(yy - 20 - i, xx - 25 + 2 * i) < r
            speck = np.hypot(yy - 40, xx - 50) < 2      # a second component
            prob[i] = np.where(blob | speck, 0.3, 0.01) \
                * rng.uniform(0.9, 1.1, (45, 57))
        if case == "tie":
            prob[3] = prob[1]
    want = np.asarray(jrefine.postprocess_roi_stack(jnp.asarray(prob), 0.05))
    got = trefine.postprocess_roi_stack(_t(prob), 0.05)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    jsel, jframe = jselect.select_max_area_frame(jnp.asarray(want))
    sel, frame = tselect.select_max_area_frame(got)
    assert int(frame) == int(jframe) == (-1 if case == "empty" else 1)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    assert sel.dtype == torch.uint8
    # values above 1 count as foreground and come back as 1
    sel3, f3 = tselect.select_max_area_frame(got * 3)
    assert int(f3) == int(frame) and int(sel3.max()) == (case != "empty")


def test_speculative_fixed_points_settle_or_record_it(rng):
    """Inside ``cc.speculative()`` the loops run a fixed number of iterations
    and read nothing back: clean rings and disks settle (records unset,
    results equal the exact loops'); speckled masks, whose labels need about
    ten passes, leave the labelling's record set."""
    yy, xx = np.mgrid[:37, :45]
    r = np.hypot(yy - 18, xx - 22)
    clean = np.stack([(r > 6) & (r < 12), r < 9,
                      ((r > 10) & (r < 15)) | (r < 3)]).astype(np.uint8)
    want_l = tcc.largest_component(_t(clean), 8, min_area=5)
    want_f = tmorph.fill_holes(_t(clean))
    with tcc.speculative() as unsettled:
        got_l = tcc.largest_component(_t(clean), 8, min_area=5)
        got_f = tmorph.fill_holes(_t(clean))
    assert len(unsettled) == 2 and not any(bool(u) for u in unsettled)
    assert torch.equal(got_l, want_l) and torch.equal(got_f, want_f)

    speckled = _blobs(rng, 3, 37, 45)
    want = tcc.label_components(_t(speckled), 8)
    with tcc.speculative() as unsettled:
        got = tcc.label_components(_t(speckled), 8)
    assert bool(unsettled[0]) and not torch.equal(got, want)
    with pytest.raises(RuntimeError):
        with tcc.speculative():
            with tcc.speculative():
                pass
    assert tcc._unsettled is None


def test_bin_counts_equals_bincount(rng):
    from att_aspp_unet_tpu_torch.ops.image import bin_counts
    idx = rng.integers(0, 50, (7, 31))
    np.testing.assert_array_equal(bin_counts(_t(idx), 64).numpy(),
                                  np.bincount(idx.ravel(), minlength=64))
