"""The port's losses (omnidata_tpu_torch.losses) against the JAX package's
on the CPU: values, and gradients against ``jax.grad``, on inputs made with
numpy from a seed. The VNL's triplets come from JAX's ``sample_triplets``
and go to both sides.

Tolerances, float32: values within rtol 1e-5 (atol 1e-6); gradients within
1e-5 of the largest JAX gradient entry (the two frameworks sum reductions
in their own orders); the VNL (sorts, square roots, 3x3 products over
thousands of triplets) within rtol 1e-4 and gradients 1e-4 of the largest.
Index choices (medians, hard-example ranks) must agree exactly, which the
gradients show: the gradient lands on the element the sort picked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnidata_tpu import losses as jl
from omnidata_tpu.losses import midas as jmidas
from omnidata_tpu_torch import losses as tl
from omnidata_tpu_torch.losses import midas as tmidas

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5
VNL_RTOL, VNL_GRAD_TOL = 1e-4, 1e-4


def _rand(shape, seed, positive=False):
    x = np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return x * 0.9 + 0.05 if positive else x


def _grad_close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _both(jfn, tfn, args, wrt=(0,), bools=()):
    """Value and gradients (w.r.t. args[wrt]) of a scalar loss, JAX and
    port, from the same numpy args; args in ``bools`` are masks."""
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.tensor(a, requires_grad=(i in wrt)) for i, a in enumerate(args)]
    jv, jg = jax.jit(jax.value_and_grad(lambda *a: jfn(*a), argnums=wrt))(*jargs)
    tv = tfn(*targs)
    tv.backward()
    tg = [np.zeros(args[i].shape, np.float32) if targs[i].grad is None
          else targs[i].grad.numpy() for i in wrt]  # None: no dependence
    return float(jv), float(tv.detach()), [np.asarray(g) for g in jg], tg


def _check(jfn, tfn, args, wrt=(0,), rtol=RTOL, gtol=GRAD_TOL):
    jv, tv, jg, tg = _both(jfn, tfn, args, wrt)
    np.testing.assert_allclose(tv, jv, rtol=rtol, atol=ATOL)
    for a, b in zip(tg, jg):
        _grad_close(a, b, gtol)
    return jv


@pytest.mark.parametrize("name", ["masked_l1_loss", "masked_mse_loss",
                                  "masked_cosine_angular_loss"])
@pytest.mark.parametrize("mask_kind", ["random", "all", "none", "broadcast"])
def test_masked_losses_and_gradients(name, mask_kind):
    pred, tgt = _rand((2, 3, 8, 8), 1), _rand((2, 3, 8, 8), 2)
    shape = (2, 1, 8, 8) if mask_kind == "broadcast" else (2, 3, 8, 8)
    mask = {"random": _rand(shape, 3) > 0.4, "all": np.ones(shape, bool),
            "none": np.zeros(shape, bool), "broadcast": _rand(shape, 3) > 0.4}[mask_kind]
    jfn, tfn = getattr(jl, name), getattr(tl, name)
    v = _check(lambda p, t: jfn(p, t, jnp.asarray(mask)),
               lambda p, t: tfn(p, t, torch.from_numpy(mask)), [pred, tgt], wrt=(0, 1))
    if mask_kind == "none":
        assert v == 0.0


def test_clip_gradient_at_the_bounds_is_half_as_in_jax():
    x = np.array([-0.5, 0.0, 0.25, 1.0, 1.5], np.float32)
    jg = jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 1.0) * jnp.arange(1.0, 6.0)))(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    (tl.clip(t, 0.0, 1.0) * torch.arange(1.0, 6.0)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(t.grad.numpy(), [0, 1, 3, 2, 0])  # 0.5 x 2, 0.5 x 4
    c = torch.tensor(x, requires_grad=True)
    torch.clamp(c, 0.0, 1.0).sum().backward()
    assert c.grad[1] == 1.0  # torch.clamp differs: why the port uses clip


@pytest.mark.parametrize("count", [0, 1, 4, 5, 16])
def test_masked_median_lower_median_and_ties(count):
    """Rows of repeated values: the lower median for even counts, 0 for no
    valid element, and the gradient on the element a stable sort picks."""
    rng = np.random.RandomState(count)
    x = rng.randint(0, 4, (3, 16)).astype(np.float32)  # many ties
    mask = np.zeros((3, 16), bool)
    for r in range(3):
        mask[r, rng.permutation(16)[:count]] = True
    w = rng.rand(3).astype(np.float32)

    def jf(a):
        return jnp.sum(jmidas._masked_median(a, jnp.asarray(mask)) * w)

    def tf(a):
        return torch.sum(tmidas._masked_median(a, torch.from_numpy(mask)) * torch.from_numpy(w))

    jv, tv, jg, tg = _both(jf, tf, [x])
    np.testing.assert_allclose(tv, jv, rtol=RTOL)  # a weighted sum of exact medians
    np.testing.assert_array_equal(tg[0], jg[0])  # w placed where the sort picked
    got = tmidas._masked_median(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jmidas._masked_median(
        jnp.asarray(x), jnp.asarray(mask))))


def test_midas_pieces_and_gradients():
    pred = _rand((2, 1, 16, 16), 11, positive=True)
    gt = _rand((2, 1, 16, 16), 12, positive=True)
    mask = _rand((2, 1, 16, 16), 13) > 0.3
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    _check(lambda p, g: jl.ssi_mae(p, g, jm), lambda p, g: tl.ssi_mae(p, g, tm),
           [pred, gt], wrt=(0, 1))
    for i in (0, 1):
        _check(lambda p, g: jnp.sum(jl.masked_shift_and_scale(p, g, jm)[i] ** 2),
               lambda p, g: torch.sum(tl.masked_shift_and_scale(p, g, tm)[i] ** 2),
               [pred, gt], wrt=(0, 1))
    p2, g2, m2 = pred[:, 0], gt[:, 0], mask[:, 0]
    for i in (0, 1):
        _check(lambda p, g: jnp.sum(jl.compute_scale_and_shift(p, g, jnp.asarray(m2))[i]),
               lambda p, g: torch.sum(tl.compute_scale_and_shift(p, g, torch.from_numpy(m2))[i]),
               [p2, g2], wrt=(0, 1))
    for reduction in ("batch-based", "image-based"):
        _check(lambda p, g: jl.gradient_matching_term(p, g, jnp.asarray(m2), reduction=reduction),
               lambda p, g: tl.gradient_matching_term(p, g, torch.from_numpy(m2),
                                                      reduction=reduction),
               [p2, g2], wrt=(0, 1))
    for i in range(3):
        _check(lambda p, g: jl.midas_loss(p, g, jm)[i],
               lambda p, g: tl.midas_loss(p, g, tm)[i], [pred, gt], wrt=(0, 1))


def test_midas_zero_mask_safe_and_differentiable():
    """tests/test_losses.py:157,175 on the port: finite loss and gradient
    with no valid pixel, equal to JAX's."""
    ones = np.ones((1, 1, 4, 4), np.float32)
    zero = np.zeros((1, 1, 4, 4), bool)
    assert float(tl.masked_l1_loss(torch.from_numpy(ones), torch.from_numpy(ones),
                                   torch.from_numpy(zero))) == 0.0
    for i in range(3):
        _check(lambda p: jl.midas_loss(p, jnp.asarray(ones), jnp.asarray(zero))[i],
               lambda p: tl.midas_loss(p, torch.from_numpy(ones), torch.from_numpy(zero))[i],
               [ones])


def test_transfer_xyz_matches_jax():
    d = _rand((2, 1, 6, 10), 5, positive=True)
    p = jl.VNLParams(3.0, 2.0, (6, 10))
    got = tl.transfer_xyz(torch.from_numpy(d), tl.VNLParams(*p))
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.transfer_xyz(jnp.asarray(d), p)),
                               rtol=RTOL, atol=ATOL)


def _vnl_inputs(H=24, seed=0, flat=False):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:H].astype(np.float32) / H
    gt = (0.5 + 0.3 * xx + 0.2 * yy + 0.05 * rng.rand(H, H)).astype(np.float32)
    if flat:
        gt[: H // 2] = 0.0  # a hole: degenerate and too-shallow triplets
    pred = (gt + 0.1 * rng.rand(H, H)).astype(np.float32)
    return gt[None, None], pred[None, None]


@pytest.mark.parametrize("select", [True, False])
@pytest.mark.parametrize("flat", [False, True])
def test_vnl_from_jax_triplets(select, flat):
    H = 24
    gt, pred = _vnl_inputs(H, flat=flat)
    params = jl.VNLParams(1.0, 1.0, (H, H))
    p123 = np.asarray(jl.sample_triplets(jax.random.PRNGKey(3), params))
    tparams = tl.VNLParams(*params)
    _check(lambda g, p: jl.vnl_from_indices(g, p, jnp.asarray(p123), params, select=select),
           lambda g, p: tl.vnl_from_indices(g, p, torch.from_numpy(p123).long(), tparams,
                                            select=select),
           [gt, pred], wrt=(0, 1), rtol=VNL_RTOL, gtol=VNL_GRAD_TOL)


def test_vnl_degenerate_triplets_have_finite_gradients():
    """Repeated indices give zero normals: the sqrt guard keeps the
    gradient finite (and equal to JAX's), as before the 15k switch."""
    gt, pred = _vnl_inputs(8)
    params = jl.VNLParams(1.0, 1.0, (8, 8))
    p123 = np.stack([np.arange(9), np.arange(9), (np.arange(9) * 7) % 64]).astype(np.int32)
    _check(lambda p: jl.vnl_from_indices(jnp.asarray(gt), p, jnp.asarray(p123), params),
           lambda p: tl.vnl_from_indices(torch.from_numpy(gt), p,
                                         torch.from_numpy(p123).long(), tl.VNLParams(*params)),
           [pred], rtol=VNL_RTOL, gtol=VNL_GRAD_TOL)


def test_virtual_normal_loss_samples_from_a_generator():
    gt, pred = _vnl_inputs(16)
    params = tl.VNLParams(1.0, 1.0, (16, 16))
    p123 = tl.sample_triplets(torch.Generator().manual_seed(0), params)
    assert p123.shape == (3, int(256 * 0.15)) and 0 <= int(p123.min()) and int(p123.max()) < 256
    p = torch.from_numpy(pred).requires_grad_(True)
    v = tl.virtual_normal_loss(torch.from_numpy(gt), p, torch.Generator().manual_seed(0), params)
    v.backward()
    assert torch.isfinite(v) and torch.isfinite(p.grad).all()
    assert float(v.detach()) == float(tl.vnl_from_indices(torch.from_numpy(gt), torch.from_numpy(pred),
                                                 p123, params))
