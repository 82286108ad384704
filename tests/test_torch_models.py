"""The port's models (omnidata_tpu_torch.models) against the JAX package's,
on the CPU, with JAX-initialised Flax weights carried across by the port's
``convert.state_dict_from_flax`` (biases and norm parameters perturbed
from their zero / unit init with seeded numpy noise, so that their mapping
is exercised too) and inputs made with numpy from a seed.

Tolerances, in float32: max |port - JAX| <= 1e-4 x max |JAX| for a layer,
<= 1e-3 x max |JAX| for a whole net (the two frameworks sum convolutions
and matmuls in their own orders; a net compounds that over 50 layers).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu.models import DPTHybrid as JDPT
from omnidata_tpu.models import UNet as JUNet
from omnidata_tpu.models import layers as jl
from omnidata_tpu.models.convert import _dpt_mapping as j_dpt_mapping
from omnidata_tpu.models.convert import synthesize_torch_state_dict
from omnidata_tpu_torch.models import DPTHybrid, UNet, create_model
from omnidata_tpu_torch.models import layers as tl
from omnidata_tpu_torch.models.convert import (
    _dpt_mapping,
    _unet_mapping,
    state_dict_from_flax,
)
from omnidata_tpu_torch.models.registry import cast_params_bf16

torch.set_num_threads(1)

LAYER_TOL = 1e-4
NET_TOL = 1e-3


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, tol * scale)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _perturbed(variables, seed):
    """Flax variables as nested numpy dicts, 1-D leaves (biases, norm
    scales and shifts) plus N(0, 0.05) noise."""
    rng = np.random.RandomState(seed)
    host = jax.device_get(variables)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        a = np.asarray(node, np.float32)
        if a.ndim == 1:
            a = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return walk(dict(host))


def _jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("out_hw", [(16, 20), (5, 7)])
def test_resize_bilinear_matches_jax(align_corners, out_hw):
    x = np.random.RandomState(0).rand(2, 8, 10, 3).astype(np.float32)
    want = np.asarray(jl.resize_bilinear(jnp.asarray(x), out_hw, align_corners))
    got = _to_nhwc(tl.resize_bilinear(_nchw(x), out_hw, align_corners))
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("shape,out_hw", [((8, 10), (16, 20)), ((16, 20), (6, 7)),
                                          ((128, 128), (512, 512))])
def test_resize_bicubic_matches_jax(shape, out_hw):
    """Keys a = -0.5 with in-bounds renormalisation (not torch's bicubic),
    antialiased when shrinking: jax.image.resize(method="cubic")."""
    x = np.random.RandomState(1).rand(1, *shape, 2).astype(np.float32)
    want = np.asarray(jl.resize_bicubic(jnp.asarray(x), out_hw))
    got = _to_nhwc(tl.resize_bicubic(_nchw(x), out_hw))
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("grid", [8, 12, 32])
def test_antialiased_linear_resize_matches_jax(grid):
    """The position-embedding resize of DPT (jax.image.resize bilinear):
    24 -> 8 and 12 antialias, 24 -> 32 plain."""
    x = np.random.RandomState(2).standard_normal((1, 24, 24, 16)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, grid, grid, 16), "bilinear"))
    got = _to_nhwc(tl.resize_scaled(_nchw(x), (grid, grid), "linear"))
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("size", [9, 10])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (7, 2), (1, 2)])
def test_stdconv_matches_jax(size, k, stride):
    """Weight standardisation and TF "SAME" padding, which pads (0, 1) for a
    strided window on an even size."""
    x = np.random.RandomState(3).rand(2, size, size, 4).astype(np.float32)
    conv = jl.StdConv(8, (k, k), (stride, stride))
    v = _perturbed(conv.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    want = np.asarray(conv.apply(_jnp_tree(v), jnp.asarray(x)))
    tconv = tl.StdConv(4, 8, k, stride, bias=True)
    tconv.load_state_dict({"weight": torch.from_numpy(
        v["params"]["kernel"].transpose(3, 2, 0, 1).copy()),
        "bias": torch.tensor(v["params"]["bias"])})
    with torch.no_grad():
        got = _to_nhwc(tconv(_nchw(x)))
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("size", [9, 10])
def test_max_pool_same_matches_flax(size):
    from flax import linen as nn

    x = np.random.RandomState(4).standard_normal((1, size, size, 3)).astype(np.float32)
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    np.testing.assert_array_equal(_to_nhwc(tl.max_pool_same(_nchw(x), 3, 2)), want)


def test_group_norm_act_matches_jax():
    x = np.random.RandomState(5).standard_normal((2, 6, 5, 64)).astype(np.float32)
    for act in (True, False):
        m = jl.GroupNormAct(act=act)
        v = _perturbed(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), 5)
        want = np.asarray(m.apply(_jnp_tree(v), jnp.asarray(x)))
        t = tl.GroupNormAct(64, act=act)
        t.load_state_dict({"weight": torch.tensor(v["params"]["gn"]["scale"]),
                           "bias": torch.tensor(v["params"]["gn"]["bias"])})
        with torch.no_grad():
            _close(_to_nhwc(t(_nchw(x))), want, LAYER_TOL)


def _block_state(v, prefix=""):
    p = v["params"]
    sd = {}
    for name in ("qkv", "proj"):
        src = p[name] if not prefix else p["attn"][name]
        sd[f"{prefix}{name}.weight"] = torch.from_numpy(src["kernel"].T.copy())
        sd[f"{prefix}{name}.bias"] = torch.from_numpy(src["bias"].copy())
    return sd


def test_attention_matches_jax():
    x = np.random.RandomState(6).standard_normal((2, 17, 64)).astype(np.float32)
    m = jl.Attention(dim=64, num_heads=4)
    v = _perturbed(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), 6)
    want = np.asarray(m.apply(_jnp_tree(v), jnp.asarray(x)))
    t = tl.Attention(64, 4)
    t.load_state_dict(_block_state(v))
    with torch.no_grad():
        _close(t(torch.from_numpy(x)).numpy(), want, LAYER_TOL)


def _encoder_state(v):
    p = v["params"]
    sd = _block_state(v, "attn.")
    for n in ("norm1", "norm2"):
        sd[f"{n}.weight"] = torch.tensor(p[n]["scale"])
        sd[f"{n}.bias"] = torch.tensor(p[n]["bias"])
    for n in ("fc1", "fc2"):
        sd[f"mlp.{n}.weight"] = torch.from_numpy(p["mlp"][n]["kernel"].T.copy())
        sd[f"mlp.{n}.bias"] = torch.tensor(p["mlp"][n]["bias"])
    return sd


def test_encoder_block_matches_jax():
    x = np.random.RandomState(7).standard_normal((2, 17, 64)).astype(np.float32)
    m = jl.EncoderBlock(64, 4)
    v = _perturbed(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), 7)
    want = np.asarray(m.apply(_jnp_tree(v), jnp.asarray(x)))
    t = tl.EncoderBlock(64, 4)
    t.load_state_dict(_encoder_state(v))
    with torch.no_grad():
        _close(t(torch.from_numpy(x)).numpy(), want, LAYER_TOL)


def test_encoder_block_bf16_within_one_percent():
    """tests/test_models.py:302's per-block bound, on the port: one
    EncoderBlock(768, 12) with bfloat16 weights (norms float32) and
    activations within 0.01 relative error of float32."""
    m = jl.EncoderBlock(768, 12)
    v = jax.device_get(jax.jit(m.init)(jax.random.PRNGKey(0), jnp.zeros((1, 10, 768))))
    t = tl.EncoderBlock(768, 12)
    t.load_state_dict(_encoder_state(v))
    x = torch.from_numpy(np.random.RandomState(2).standard_normal((1, 10, 768))
                         .astype(np.float32))
    with torch.no_grad():
        a = t(x)
        b = cast_params_bf16(t)(x.to(torch.bfloat16)).float()
    assert t.norm1.weight.dtype == torch.float32 and t.attn.qkv.weight.dtype == torch.bfloat16
    rel = float((a - b).abs().max() / (a.abs().max() + 1e-6))
    assert rel < 0.01, rel


@pytest.fixture(scope="module")
def dpt_flax():
    """JAX DPTHybrid (depth) variables, initialised at 128² and perturbed;
    the normal variant swaps in a 3-channel head_conv3."""
    m = JDPT(num_channels=1)
    v = _perturbed(jax.jit(m.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 3))), 8)
    rng = np.random.RandomState(9)
    vn = jax.tree.map(lambda a: a, v)
    vn["params"]["head_conv3"] = {
        "kernel": (rng.standard_normal((1, 1, 32, 3)) / math.sqrt(32)).astype(np.float32),
        "bias": (0.05 * rng.standard_normal(3)).astype(np.float32)}
    return {1: v, 3: vn}


def _port_dpt(variables, num_channels):
    net = DPTHybrid(num_channels=num_channels)
    net.load_state_dict(state_dict_from_flax(_dpt_mapping(), variables), strict=True)
    return net.eval()


@pytest.mark.parametrize("num_channels,size", [(1, 128), (1, 192), (3, 128)])
def test_dpt_hybrid_matches_jax(dpt_flax, num_channels, size):
    """The whole net: depth at 128² (the 24² position-embedding grid shrinks
    to 8², antialiased) and 192² (to 12²), normals at 128²."""
    v = dpt_flax[num_channels]
    x = np.random.RandomState(10 + size).rand(1, size, size, 3).astype(np.float32)
    want = np.asarray(jax.jit(JDPT(num_channels=num_channels).apply)(
        _jnp_tree(v), jnp.asarray(x)))
    with torch.no_grad():
        got = _to_nhwc(_port_dpt(v, num_channels)(_nchw(x)))
    assert got.shape == (1, size, size, num_channels)
    _close(got, want, NET_TOL)


def _published_keys():
    from test_models import _published_dpt_ckpt_keys

    return _published_dpt_ckpt_keys()


def test_dpt_state_dict_is_the_published_schema(dpt_flax):
    """DPTHybrid's keys are _dpt_mapping's torch keys (the port's copy and
    the JAX package's), which are the published checkpoints' key set;
    every shape is the JAX synthesis's."""
    keys = set(DPTHybrid().state_dict())
    assert keys == _published_keys()
    sd_port = state_dict_from_flax(_dpt_mapping(), dpt_flax[1])
    sd_jax = synthesize_torch_state_dict(j_dpt_mapping(), _jnp_tree(dpt_flax[1]))
    assert set(sd_port) == set(sd_jax) == keys
    for k, t in DPTHybrid().state_dict().items():
        assert tuple(t.shape) == tuple(sd_port[k].shape) == sd_jax[k].shape, k
        np.testing.assert_array_equal(sd_port[k].numpy(), np.asarray(sd_jax[k]), err_msg=k)


def test_published_layout_checkpoint_loads_strict(dpt_flax, tmp_path):
    """{"state_dict": {"model." + k: tensor}} as Lightning saves it: loads
    through create_model(checkpoint=...) with strict=True, every tensor as
    saved; a missing key is refused."""
    sd = state_dict_from_flax(_dpt_mapping(), dpt_flax[1])
    path = str(tmp_path / "omnidata_dpt_depth_v2.ckpt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()},
                "epoch": 0, "global_step": 0}, path)
    model = create_model("depth_dpt_hybrid_384", checkpoint=path, device="cpu")
    loaded = model.net.state_dict()
    assert set(loaded) == set(sd)
    for k, v in sd.items():
        assert torch.equal(loaded[k], v), k
    bad = dict(sd)
    bad.pop("pretrained.model.head.weight")
    with pytest.raises(RuntimeError, match="Missing key"):
        DPTHybrid().load_state_dict(bad, strict=True)


def test_bf16_cast_keeps_norms_f32(dpt_flax):
    model = create_model("surface_normal_dpt_hybrid_384", dtype="bfloat16",
                         device="cpu", generator=torch.Generator().manual_seed(1))
    norms = [m for m in model.modules()
             if isinstance(m, (torch.nn.GroupNorm, torch.nn.LayerNorm))]
    assert len(norms) == 2 * 12 + 1 + 1 + 3 * 16 + 3
    assert all(p.dtype == torch.float32 for m in norms for p in m.parameters())
    norm_ids = {id(p) for m in norms for p in m.parameters()}
    others = [p for p in model.parameters() if id(p) not in norm_ids]
    assert others and all(p.dtype == torch.bfloat16 for p in others)
    with torch.no_grad():
        y = model(torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(2)))
    assert y.shape == (1, 3, 64, 64) and y.dtype == torch.float32


def test_seeded_init_is_reproducible():
    a = create_model("surface_normal_unet", device="cpu",
                     generator=torch.Generator().manual_seed(3))
    b = create_model("surface_normal_unet", device="cpu",
                     generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    with pytest.raises(KeyError):
        create_model("nope", device="cpu")


def test_unet_matches_jax():
    m = JUNet(out_channels=3)
    x = np.random.RandomState(12).rand(1, 64, 64, 3).astype(np.float32)
    v = _perturbed(jax.jit(m.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))), 12)
    want = np.asarray(jax.jit(m.apply)(_jnp_tree(v), jnp.asarray(x)))
    net = UNet(out_channels=3)
    sd = state_dict_from_flax(_unet_mapping(), v)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = _to_nhwc(net(_nchw(x)))
    _close(got, want, NET_TOL)


def test_cuda_model_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("depth_dpt_hybrid_384")
