"""MiDaS v2.1 in the port (omnidata_tpu_torch.models.midas_full, midas_net,
midas_transforms, the registry's midas_v21*) against the JAX package's, on
the CPU: Flax weights (JAX-initialised, every 1-D leaf — biases, norm
scales and shifts, BatchNorm means and variances — plus seeded N(0, 0.05)
noise) carried across by the port's ``convert.state_dict_from_flax`` or by
the JAX package's ``synthesize_torch_state_dict`` in the published key
schema; inputs made with numpy from a seed.

Tolerances, in float32: 1e-5 absolute for a block on unit-scale inputs;
1e-4 x max |JAX| for a whole net (the frameworks sum convolutions in their
own orders, and ResNeXt101 compounds that over 100 layers); the resize
bit for bit with PIL; the transforms within 1e-6 (a division and a
subtraction in float32, equal in both).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from omnidata_tpu.models import midas_full as jmf
from omnidata_tpu.models import midas_transforms as jmt
from omnidata_tpu.models import registry as jreg
from omnidata_tpu.models.convert import _midas_mapping as j_midas_mapping
from omnidata_tpu.models.convert import _midas_small_mapping as j_midas_small_mapping
from omnidata_tpu.models.convert import synthesize_torch_state_dict
from omnidata_tpu.models.midas_net import InvertedResidual as JInvertedResidual
from omnidata_tpu.models.midas_net import MidasNetSmall as JMidasNetSmall
from omnidata_tpu_torch.models import create_model, midas_full, midas_transforms
from omnidata_tpu_torch.models.convert import (
    _bottleneck_mapping,
    _mbconv_mapping,
    _midas_mapping,
    _midas_net_small_mapping,
    _midas_small_mapping,
    state_dict_from_flax,
    state_dict_from_flax_tree,
)
from omnidata_tpu_torch.models.dpt import ResidualConvUnit
from omnidata_tpu_torch.models.midas_net import InvertedResidual, MidasNetSmall
from omnidata_tpu_torch.utils.pil_image import pil_bicubic_resize

torch.set_num_threads(1)

BLOCK_ATOL = 1e-5
NET_TOL = 1e-4
TRANSFORM_ATOL = 1e-6
SIZES = [(64, 64), (64, 96)]


def _perturbed(variables, seed):
    """Flax variables as nested numpy dicts, 1-D leaves plus N(0, 0.05)."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if a.ndim == 1:
            a = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return walk(dict(jax.device_get(variables)))


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _net_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    assert err <= NET_TOL * scale, (err, NET_TOL * scale)


def _block_pair(jmod, tmod, x, to_state, seed):
    v = _perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)
    tmod.load_state_dict(to_state(v), strict=True)
    tmod.eval()
    want = np.asarray(jmod.apply(_jtree(v), jnp.asarray(x)))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=BLOCK_ATOL)


def _unit(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


# ---- blocks ----------------------------------------------------------------

def test_residual_conv_unit_matches_jax():
    x = _unit((2, 9, 10, 16), 0)
    _block_pair(jmf.ResidualConvUnit(16), ResidualConvUnit(16), x,
                state_dict_from_flax_tree, 0)


@pytest.mark.parametrize("with_skip", [True, False])
def test_feature_fusion_block_matches_jax(with_skip):
    """Plain fusion, x2 align-corners upsampling; refinenet4 runs without
    the skip (its resConfUnit1 then unused on both sides)."""
    x, s = _unit((1, 6, 7, 16), 1), _unit((1, 6, 7, 16), 2)
    jm = jmf.FeatureFusionBlock(16)
    v = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(s)), 1)
    tm = midas_full.FeatureFusionBlock(16)
    tm.load_state_dict(state_dict_from_flax_tree(v), strict=True)
    skip = (jnp.asarray(s),) if with_skip else ()
    want = np.asarray(jm.apply(_jtree(v), jnp.asarray(x), *skip))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x), *((_nchw(s),) if with_skip else ())))
    assert got.shape == (1, 12, 14, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=BLOCK_ATOL)


@pytest.mark.parametrize("expand", [True, False])
def test_feature_fusion_block_custom_matches_jax(expand):
    """Custom fusion: Flax's resConfUnit{u}_conv{c} are the published
    resConfUnit{u}.conv{c}; expand halves the output channels."""
    x, s = _unit((1, 5, 6, 16), 3), _unit((1, 5, 6, 16), 4)
    jm = jmf.FeatureFusionBlockCustom(16, expand=expand)
    v = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(s)), 2)
    sd = {re.sub(r"(resConfUnit\d)_", r"\1.", k): t
          for k, t in state_dict_from_flax_tree(v).items()}
    tm = midas_full.FeatureFusionBlockCustom(16, expand=expand)
    tm.load_state_dict(sd, strict=True)
    want = np.asarray(jm.apply(_jtree(v), jnp.asarray(x), jnp.asarray(s)))
    with torch.no_grad():
        got = _nhwc(tm(_nchw(x), _nchw(s)))
    assert got.shape == (1, 10, 12, 8 if expand else 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=BLOCK_ATOL)


@pytest.mark.parametrize("size", [16, 15])
@pytest.mark.parametrize("stride,downsample,in_ch", [(1, False, 64), (1, True, 32),
                                                     (2, True, 32)])
def test_resnext_bottleneck_matches_jax(stride, downsample, in_ch, size):
    """Grouped 3x3 (32 groups of 2 at planes 16) with torchvision's static
    padding 1, BatchNorm eps 1e-5 on running statistics, the strided 1x1
    conv + BatchNorm shortcut."""
    x = _unit((2, size, size, in_ch), 5)
    _block_pair(jmf.ResNeXtBottleneck(16, stride=stride, downsample=downsample),
                midas_full.ResNeXtBottleneck(in_ch, 16, stride, downsample=downsample), x,
                lambda v: state_dict_from_flax(list(_bottleneck_mapping("", "", downsample)), v),
                3)


@pytest.mark.parametrize("size", [16, 15])
@pytest.mark.parametrize("kernel,stride,expand,in_ch,out_ch", [
    (3, 1, 1, 32, 24), (3, 1, 1, 24, 24), (3, 2, 6, 24, 32), (5, 2, 6, 32, 48),
    (5, 1, 6, 48, 48), (3, 1, 6, 16, 24)])
def test_mbconv_lite_matches_jax(kernel, stride, expand, in_ch, out_ch, size):
    """Depthwise convs with Flax SAME padding (the odd pixel after at stride
    2 on even sizes), relu6, BatchNorm eps 1e-3, the residual at stride 1
    with equal widths; geffnet's names for expand 1 and 6."""
    x = _unit((2, size, size, in_ch), 6)
    _block_pair(jmf.MBConvLite(out_ch, kernel, stride, expand),
                midas_full.MBConvLite(in_ch, out_ch, kernel, stride, expand), x,
                lambda v: state_dict_from_flax(list(_mbconv_mapping("", "", expand)), v), 4)


@pytest.mark.parametrize("size", [16, 15])
@pytest.mark.parametrize("stride,in_ch,features", [(1, 24, 24), (2, 24, 40), (1, 16, 24)])
def test_inverted_residual_matches_jax(stride, in_ch, features, size):
    x = _unit((2, size, size, in_ch), 7)
    _block_pair(JInvertedResidual(features, stride=stride),
                InvertedResidual(in_ch, features, stride), x, state_dict_from_flax_tree, 5)


def test_lite3_stages_and_taps():
    """tests/test_models.py:345's pins on the port: stage widths and
    repeats, tap channels [32, 48, 136, 384] at strides 4, 8, 16, 32."""
    assert midas_full.lite3_stage_channels() == jmf.lite3_stage_channels()
    bb = midas_full.EfficientNetLite3Backbone().eval()
    with torch.no_grad():
        feats = bb(torch.zeros(1, 3, 128, 128))
    assert [tuple(f.shape[1:]) for f in feats] == [(32, 32, 32), (48, 16, 16),
                                                  (136, 8, 8), (384, 4, 4)]


# ---- whole nets --------------------------------------------------------------

NETS = {
    # name: (JAX module, JAX published mapping, port module, port mapping)
    "midas_v21": (jmf.MidasNet, j_midas_mapping, midas_full.MidasNet, _midas_mapping),
    "midas_v21_small": (jmf.MidasNetSmallTF, j_midas_small_mapping,
                        midas_full.MidasNetSmallTF, _midas_small_mapping),
}


@pytest.fixture(scope="module", params=sorted(NETS))
def net(request, tmp_path_factory):
    """One MiDaS net at full depth and published widths: perturbed Flax
    variables, their published-schema state dict (the JAX package's
    ``synthesize_torch_state_dict``) saved as a checkpoint, the JAX
    registry's bundle on that checkpoint and the JAX outputs at SIZES."""
    name = request.param
    jcls, jmap, tcls, tmap = NETS[name]
    v = _perturbed(jax.jit(jcls().init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 11)
    sd = {k: torch.from_numpy(np.array(a, np.float32))
          for k, a in synthesize_torch_state_dict(list(jmap()), v).items()}
    ckpt = tmp_path_factory.mktemp(name) / f"{name}.pt"
    torch.save(sd, ckpt)
    bundle = getattr(jreg, name)(checkpoint=str(ckpt))
    xs = {hw: np.random.RandomState(hw[1]).rand(1, 3, *hw).astype(np.float32)
          for hw in SIZES}
    want = {hw: np.asarray(bundle.apply(bundle.variables, jnp.asarray(x)))
            for hw, x in xs.items()}
    del bundle
    return {"name": name, "variables": v, "sd": sd, "ckpt": str(ckpt), "x": xs,
            "want": want, "port": tcls, "port_mapping": tmap}


def test_published_state_dict_loads_strictly_into_the_port(net):
    """The JAX package's published-schema state dict has exactly the
    port's keys (without num_batches_tracked) and loads with strict=True;
    the port's own mapping gives the same tensors."""
    model = net["port"]()
    keys = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(net["sd"]) == keys, set(net["sd"]) ^ keys
    model.load_state_dict(net["sd"], strict=True)
    mine = state_dict_from_flax(list(net["port_mapping"]()), net["variables"])
    assert set(mine) == set(net["sd"])
    for k, t in net["sd"].items():
        assert torch.equal(mine[k], t), k


@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_midas_net_matches_jax(net, hw):
    """MidasNet / MidasNetSmallTF at full depth on Flax-carried weights:
    (B, H, W) within 1e-4 x max |JAX|, square and not."""
    model = net["port"]()
    model.load_state_dict(state_dict_from_flax(list(net["port_mapping"]()),
                                               net["variables"]), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(net["x"][hw]))
    assert tuple(got.shape) == (1, *hw)
    _net_close(got.numpy(), net["want"][hw])


def test_create_model_loads_the_published_checkpoint(net):
    """create_model(name, checkpoint=<the JAX mapping's state dict,
    torch.save'd>, device="cpu") gives the JAX registry bundle's output on
    the same file; non-negative."""
    model = create_model(net["name"], checkpoint=net["ckpt"], device="cpu")
    assert not model.training and not model.net.training
    hw = SIZES[0]
    with torch.no_grad():
        got = model(torch.from_numpy(net["x"][hw]))
    assert float(got.min()) >= 0
    _net_close(got.numpy(), net["want"][hw])


@pytest.mark.parametrize("name", sorted(NETS))
def test_midas_entries_refuse_bfloat16(name):
    """The JAX package's MiDaS entries take no dtype: the port's stay
    float32 and refuse bfloat16."""
    with pytest.raises(ValueError, match="float32"):
        create_model(name, device="cpu", dtype="bfloat16")


def test_midas_net_small_matches_jax():
    """The role-equivalent GroupNorm net (midas_net.MidasNetSmall) at 64²:
    (B, 1, H, W) against Flax's (B, H, W, 1)."""
    jm = JMidasNetSmall()
    x = np.random.RandomState(3).rand(1, 64, 64, 3).astype(np.float32)
    v = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 12)
    want = np.asarray(jax.jit(jm.apply)(_jtree(v), jnp.asarray(x)))
    model = MidasNetSmall()
    model.load_state_dict(state_dict_from_flax(list(_midas_net_small_mapping()), v),
                          strict=True)
    with torch.no_grad():
        got = _nhwc(model.eval()(_nchw(x)))
    _net_close(got, want)


# ---- transforms --------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [
    ((480, 640), (288, 384)), ((480, 640), (192, 256)), ((37, 53), (91, 120)),
    ((64, 64), (17, 33)), ((100, 7), (3, 250)), ((288, 384), (480, 640))])
def test_pil_bicubic_resize_equals_pil(src, dst):
    """PIL's BICUBIC (Keys a = -0.5, support 2 widened when shrinking,
    22-bit fixed point with negative taps, two passes) bit for bit."""
    img = np.random.RandomState(sum(src) + sum(dst)).randint(0, 256, (*src, 3)).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BICUBIC))
    np.testing.assert_array_equal(pil_bicubic_resize(img, dst[::-1]), want)


@pytest.mark.parametrize("which,shape", [("v21", (3, 288, 384)), ("v21_small", (3, 192, 256))])
@pytest.mark.parametrize("hw", [(480, 640), (500, 333)])
def test_midas_transforms_match_jax(which, shape, hw):
    """midas_transform_v21 / _v21_small against JAX's (PIL's bicubic of the
    truncated 8-bit image) within 1e-6; the 640x480 shapes of
    tests/test_models.py:454."""
    img = np.random.RandomState(hw[0]).rand(*hw, 3).astype(np.float32)
    want = getattr(jmt, f"midas_transform_{which}")()({"image": img})["image"]
    got = getattr(midas_transforms, f"midas_transform_{which}")()({"image": img})["image"]
    assert got.dtype == np.float32 and got.flags.c_contiguous
    assert got.shape == want.shape
    if hw == (480, 640):
        assert got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TRANSFORM_ATOL)


@pytest.mark.parametrize("method", ["lower_bound", "upper_bound", "minimal"])
@pytest.mark.parametrize("keep", [True, False])
def test_resize_sizes_match_jax(method, keep):
    for w, h in ((640, 480), (333, 500), (384, 384), (1000, 97)):
        jr = jmt.Resize(384, 256, keep_aspect_ratio=keep, resize_method=method)
        tr = midas_transforms.Resize(384, 256, keep_aspect_ratio=keep, resize_method=method)
        assert tr.get_size(w, h) == jr.get_size(w, h)
