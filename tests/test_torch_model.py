"""Port parity of the model forward: the port's AttentionASPPUNet (weights
through ``jax_variables_to_torch``) against the flax model and the JAX
package's packed fast path."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from att_aspp_unet_tpu.config import ModelConfig as JModelConfig
from att_aspp_unet_tpu.infer import fast_forward
from att_aspp_unet_tpu.models import AttentionASPPUNet as JModel
from att_aspp_unet_tpu_torch.config import ModelConfig
from att_aspp_unet_tpu_torch.utils.convert import jax_variables_to_torch
from att_aspp_unet_tpu_torch.utils.npz_weights import load_npz_variables
from .test_torch_threads import one_torch_thread  # noqa: F401

WEIGHTS = Path(__file__).resolve().parents[1] / "resources/synthetic/weights.npz"


def random_variables(base_c: int, seed: int = 0, hw: int = 32,
                     use_aspp: bool = True, gain: float = 1.0):
    """A flax variables tree of the v1 model (with the ASPP or the
    ``--no_aspp`` bridge) with every leaf drawn from a numpy generator (BN
    variances positive, scales near 1, kernels of variance gain /
    fan-in)."""
    model = JModel.from_config(JModelConfig(base_c=base_c, use_aspp=use_aspp,
                                            compute_dtype="float32"))
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 1)),
                           train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        coll = str(path[0].key)
        if coll == "batch_stats":
            return (rng.random(s.shape) + 0.5 if name == "var"
                    else rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        if name == "scale":
            return (rng.random(s.shape) + 0.5).astype(np.float32)
        if name == "bias":
            return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in / gain)
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _flax_logits(variables, base_c, x_nchw):
    model = JModel.from_config(JModelConfig(base_c=base_c,
                                            compute_dtype="float32"))
    out, _ = model.apply(variables, jnp.asarray(x_nchw.transpose(0, 2, 3, 1)),
                         train=False)
    return np.asarray(out).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("hw", [64, 128])
def test_forward_f32_matches_flax_and_bf16_matches_fast_path(hw):
    """f32: the port's reference-precision forward against
    ``AttentionASPPUNet.apply(train=False)`` at rtol/atol 1e-4
    (``tests/test_model_parity.py``'s bound).  bf16: the port's main-path
    precision (kernel K1's plain version on the CPU) against
    ``fast_forward.make_fast_apply(interpret=True)`` at 2e-2, the bf16
    kernel tolerance."""
    base_c = 4
    variables = random_variables(base_c)
    vnp = jax.tree_util.tree_map(np.asarray, variables)
    x = np.random.default_rng(1).random((2, 1, hw, hw)).astype(np.float32)

    want = _flax_logits(variables, base_c, x)
    m32 = jax_variables_to_torch(vnp, ModelConfig(base_c=base_c,
                                                  compute_dtype="float32"))
    got = m32(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    jmodel = JModel.from_config(JModelConfig(base_c=base_c))
    plan = fast_forward.pack_variables(jmodel, variables)
    fast = fast_forward.make_fast_apply(jmodel, interpret=True)
    want_bf = np.asarray(fast(plan, jnp.asarray(x.transpose(0, 2, 3, 1))))
    mbf = jax_variables_to_torch(vnp, ModelConfig(base_c=base_c))
    got_bf = mbf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_bf, want_bf.transpose(0, 3, 1, 2),
                               rtol=2e-2, atol=2e-2)


def test_full_width_in_repo_weights_forward():
    """The trained base_c 48 weights of the repo through the converter at
    their real shapes, f32 at a 64x64 input, against the flax forward.
    Trained logits reach ~1e1, so the bound is rtol 1e-4 with atol 1e-3
    (f32 sums over up to 9*768 terms in different orders)."""
    vnp = load_npz_variables(WEIGHTS)
    assert vnp["params"]["d1_0"]["conv"]["kernel"].shape[-1] == 48
    x = np.random.default_rng(2).random((1, 1, 64, 64)).astype(np.float32)
    want = _flax_logits({"params": vnp["params"],
                         "batch_stats": vnp["batch_stats"]}, 48, x)
    model = jax_variables_to_torch(vnp, ModelConfig(compute_dtype="float32"))
    got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_every_pair_sees_channel_last_input_and_layout_changes_no_value():
    """The model runs channel-last between its blocks: each FusedCBRPair is
    handed a tensor in ``torch.channels_last`` memory (the layout kernel K1
    reads, so no pair pays a copy) and returns one.  The input's own memory
    format changes no logit."""
    from att_aspp_unet_tpu_torch.nn.blocks import FusedCBRPair

    base_c = 4
    vnp = jax.tree_util.tree_map(np.asarray, random_variables(base_c))
    model = jax_variables_to_torch(vnp, ModelConfig(base_c=base_c))
    seen = []

    def hook(mod, args, out):
        seen.append((args[0].is_contiguous(memory_format=torch.channels_last),
                     tuple(args[0].shape)))

    pairs = [m for m in model.modules() if isinstance(m, FusedCBRPair)]
    assert len(pairs) == 8
    for m in pairs:
        m.register_forward_hook(hook)
    x = torch.from_numpy(np.random.default_rng(3).random((2, 1, 64, 64))
                         .astype(np.float32))
    logits = model(x)
    assert len(seen) == 8 and all(ok for ok, _ in seen), seen
    assert [s[1] for _, s in seen] == [1, 4, 8, 16, 64, 32, 16, 8]
    assert logits.shape == (2, 1, 64, 64) and logits.dtype == torch.float32

    # a 3-channel model: contiguous and channel-last inputs, same logits
    cfg3 = ModelConfig(base_c=base_c, in_channels=3)
    from att_aspp_unet_tpu_torch.models.att_aspp_unet import AttentionASPPUNet
    m3 = AttentionASPPUNet(cfg3).eval()
    g = torch.Generator().manual_seed(0)
    for name, buf in m3.named_buffers():
        buf.copy_(torch.randn(buf.shape, generator=g) * 0.1
                  + (1.0 if name.endswith("_s") or name[-2:] in ("s1", "s2")
                     else 0.0))
    x3 = torch.rand(1, 3, 32, 32, generator=g)
    a = m3(x3)
    b = m3(x3.contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_pair_prepacks_its_weights_once_per_weight_set():
    """``FusedCBRPair.packed()`` puts the weights into the kernel's order
    once and again only after they were written to or replaced."""
    from att_aspp_unet_tpu_torch.nn.blocks import FusedCBRPair
    from att_aspp_unet_tpu_torch.ops.kernels import fused_conv as tfc

    pair = FusedCBRPair(8, 16, 16)
    g = torch.Generator().manual_seed(1)
    pair.w1.copy_(torch.randn(pair.w1.shape, generator=g))
    pair.w2.copy_(torch.randn(pair.w2.shape, generator=g))
    first = pair.packed()
    assert pair.packed() is first
    assert torch.equal(tfc.unpack_prepacked(first.w1p, 16, 8, first.kc), pair.w1)
    assert torch.equal(tfc.unpack_prepacked(first.w2p, 16, 16, first.kc), pair.w2)
    pair.load_state_dict({k: torch.ones_like(v)
                          for k, v in pair.state_dict().items()})
    second = pair.packed()
    assert second is not first
    assert torch.equal(tfc.unpack_prepacked(second.w1p, 16, 8, second.kc), pair.w1)
