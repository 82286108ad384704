"""Refocus (thin-lens depth-of-field) augmentation, the port's counterpart
of the JAX package's ``augment/refocus.py`` (reference:
omnidata_tools/torch/data/refocus_augmentation.py:16-203), on tensors of
any device.

Per image:
1. band the depth into n_quantiles equal-mass segments (per-image
   quantiles, ``jnp.quantile``'s linear rule, the ends widened by eps);
2. the circle of confusion of each boundary: c = A |d - f| / d;
3. the blur stack: one separable gaussian per boundary radius
   (replicate-padded, a static window of ``max_cutoff`` taps whose width
   follows the radius; a radius below 0.1 is the identity);
4. each pixel composited from the two blur levels around its depth, with
   weights (1 - dist^2), normalised.

The random draws of ``refocus_augmentation`` (the focus: one of the
interior quantiles; the aperture: log-uniform in [min, max]) come from a
CPU ``torch.Generator``, so the card and the CPU draw the same numbers
for the same seed; they are not ``jax.random``'s draws.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _gaussian_window(std: torch.Tensor, m: int) -> torch.Tensor:
    """Gaussian windows of static length m, one per entry of std (any
    shape) -> std.shape + (m,), each summing to 1; a std below 0.1 gives a
    delta (the identity blur)."""
    std = torch.as_tensor(std, dtype=torch.float32)
    n = torch.arange(m, dtype=torch.float32, device=std.device) - (m - 1.0) / 2.0
    sig2 = 2.0 * torch.clamp(std, min=1e-6)[..., None] ** 2
    w = torch.exp(-(n ** 2) / sig2)
    delta = (n.abs() < 0.5).float()
    w = torch.where(std[..., None] < 0.1, delta, w)
    return w / w.sum(-1, keepdim=True)


def _blur(x: torch.Tensor, windows: torch.Tensor) -> torch.Tensor:
    """Separable blur of x (N, C, H, W), image n by windows[n] (N, m):
    replicate padding, the vertical pass, then the horizontal one, as
    grouped convolutions with one weight per (image, channel)."""
    N, C, H, W = x.shape
    m = windows.shape[-1]
    half = m // 2
    x = F.pad(x, (half, half, half, half), mode="replicate").reshape(1, N * C, H + 2 * half,
                                                                    W + 2 * half)
    w = windows.to(x.dtype).repeat_interleave(C, 0)  # (N C, m)
    x = F.conv2d(x, w.reshape(N * C, 1, m, 1), groups=N * C)
    x = F.conv2d(x, w.reshape(N * C, 1, 1, m), groups=N * C)
    return x.reshape(N, C, H, W)


def separable_gaussian(img: torch.Tensor, r, max_cutoff: int = 61) -> torch.Tensor:
    """Separable gaussian of std r (a number, or one per image) with
    replicate padding; img NCHW."""
    r = torch.as_tensor(r, dtype=torch.float32, device=img.device)
    return _blur(img, _gaussian_window(r.expand(img.shape[0]), max_cutoff))


def compute_circle_of_confusion_no_magnification(depths, aperture, focus_distance):
    """A |d - f| / d, d clamped at 1e-3 (an invalid zero depth would give
    0/0, which zero-weight levels still carry into the composite)."""
    return aperture * (depths - focus_distance).abs() / torch.clamp(depths, min=1e-3)


def compute_quantiles(depth: torch.Tensor, n_quantiles: int, eps: float = 1e-4):
    """Per-image equal-mass depth quantiles (B, n_quantiles + 1):
    ``jnp.quantile``'s linear rule on each image's sorted depths (position
    q (N - 1) in float32, its floor and ceil weighted), the first value
    lowered and the last raised by eps. Sorting and interpolating here,
    not ``torch.quantile``, which refuses rows over 2^24 entries."""
    flat = depth.reshape(depth.shape[0], -1)
    srt = torch.sort(flat, dim=1).values
    n = flat.shape[1]
    q = torch.arange(n_quantiles + 1, dtype=torch.float32, device=flat.device) / n_quantiles
    pos = q * (float(n) - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    low = low.clamp(0, n - 1).long()
    high = high.clamp(0, n - 1).long()
    vals = srt[:, low] * lw + srt[:, high] * hw
    vals[:, 0] -= eps
    vals[:, -1] += eps
    return vals


def compute_quantile_membership(depth: torch.Tensor, quantile_vals: torch.Tensor):
    """Per-pixel (dist_left, dist_right, idx_left, idx_right) against the
    per-image quantile boundaries (refocus_augmentation.py:89-104): the
    right boundary is the first one not below the depth (``searchsorted``,
    side left), clipped to [1, Q - 1]."""
    B = depth.shape[0]
    flat = depth.reshape(B, -1)
    idx_right = torch.searchsorted(quantile_vals.contiguous(), flat.contiguous())
    idx_right = idx_right.clamp(1, quantile_vals.shape[1] - 1)
    idx_left = idx_right - 1
    q_r = torch.gather(quantile_vals, 1, idx_right)
    q_l = torch.gather(quantile_vals, 1, idx_left)
    d = q_r - q_l
    dist_right = (q_r - flat) / d
    dist_left = (flat - q_l) / d
    shp = depth.shape
    return (dist_left.reshape(shp), dist_right.reshape(shp),
            idx_left.reshape(shp), idx_right.reshape(shp))


def get_blur_stack(rgb: torch.Tensor, blur_radii: torch.Tensor,
                   max_cutoff: int = 61) -> torch.Tensor:
    """(B, C, H, W) x per-image radii (B, Q) -> (B, Q, C, H, W), every level
    of every image in one pair of grouped convolutions."""
    B, C, H, W = rgb.shape
    Q = blur_radii.shape[1]
    x = rgb[:, None].expand(B, Q, C, H, W).reshape(B * Q, C, H, W)
    windows = _gaussian_window(blur_radii.reshape(-1), max_cutoff)
    return _blur(x, windows).reshape(B, Q, C, H, W)


def composite_blur_stack(blur_stack, dist_left, dist_right, idx_left, idx_right):
    """Interpolate between adjacent blur levels with (1 - d^2) weights.

    blur_stack (B, Q, C, H, W); dist_* (B, 1, H, W); idx_* (B, H, W). JAX's
    weights over all Q levels are zero but at idx_left and idx_right, so
    its normalised sum is those two levels' weighted sum, taken here."""
    B, Q, C, H, W = blur_stack.shape
    sim_l = 1.0 - dist_left ** 2  # (B, 1, H, W)
    sim_r = 1.0 - dist_right ** 2
    total = sim_l + sim_r

    def level(idx):
        return torch.gather(blur_stack, 1, idx[:, None, None].expand(B, 1, C, H, W))[:, 0]

    return (sim_l / total) * level(idx_left) + (sim_r / total) * level(idx_right)


def refocus_image(rgb, depth, focus_distance, aperture, quantile_vals,
                  max_cutoff: int = 61):
    """rgb (B, 3, H, W), depth (B, 1, H, W), focus and aperture (B, 1),
    quantile_vals (B, Q) -> the refocused rgb."""
    dist_l, dist_r, idx_l, idx_r = compute_quantile_membership(depth, quantile_vals)
    radii = compute_circle_of_confusion_no_magnification(
        quantile_vals, aperture, focus_distance)  # (B, Q)
    stack = get_blur_stack(rgb, radii, max_cutoff)
    return composite_blur_stack(stack, dist_l, dist_r, idx_l[:, 0], idx_r[:, 0])


def refocus_draws(batch: int, generator: torch.Generator, n_quantiles: int = 8,
                  aperture_min: float = 0.01, aperture_max: float = 1.0):
    """``refocus_augmentation``'s draws from a CPU generator: the focus
    quantile's index (B, 1) in [1, n_quantiles) and the aperture (B, 1),
    log-uniform in [aperture_min, aperture_max]."""
    f_idx = torch.randint(1, n_quantiles, (batch, 1), generator=generator)
    log_min = math.log(aperture_min)
    log_max = math.log(aperture_max)
    u = torch.rand((batch, 1), generator=generator)
    aperture = torch.exp(u * (log_max - log_min) + log_min)
    return f_idx, aperture


def refocus_augmentation(
    rgb: torch.Tensor,
    depth: torch.Tensor,
    generator: torch.Generator,
    n_quantiles: int = 8,
    aperture_min: float = 0.01,
    aperture_max: float = 1.0,
    max_cutoff: int = 61,
) -> torch.Tensor:
    """Random refocus: focus at a random interior quantile, aperture
    log-uniform (refocus_augmentation.py:163-203); the draws
    (``refocus_draws``) from ``generator``, a CPU ``torch.Generator``."""
    qvals = compute_quantiles(depth, n_quantiles)
    f_idx, aperture = refocus_draws(rgb.shape[0], generator, n_quantiles,
                                    aperture_min, aperture_max)
    focus = torch.gather(qvals, 1, f_idx.to(qvals.device))
    return refocus_image(rgb, depth, focus, aperture.to(rgb.device), qvals, max_cutoff)
