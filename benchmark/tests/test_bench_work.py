"""benchmark.work's pair count against a brute-force count."""
import numpy as np
import torch

from benchmark import work
from benchmark.gen import cameras
from benchmark.reference.render import screen_boxes


def brute_pairs(V, Fc, loc, R, fov, res, tile):
    lo, hi, live = screen_boxes(V[Fc], loc, R, fov, res)
    n = 0
    for fi in np.nonzero(live.numpy())[0]:
        for ty in range(res // tile):
            for tx in range(res // tile):
                x0, y0 = tx * tile, ty * tile
                if (hi[fi, 0] >= x0 and lo[fi, 0] <= x0 + tile
                        and hi[fi, 1] >= y0 and lo[fi, 1] <= y0 + tile):
                    n += tile * tile
    return n


def test_pairs_equal_brute_force_on_a_toy_scene():
    rng = np.random.RandomState(0)
    v = rng.uniform(-3, 3, (60, 3)).astype(np.float32)
    v[:, 2] = rng.uniform(0.2, 2.8, 60)
    f = rng.randint(0, 60, (40, 3))
    V, Fc = torch.as_tensor(v), torch.as_tensor(f).long()
    locs, Rs, fovs = (torch.as_tensor(x) for x in cameras.sample(3, 5))
    for i in range(3):
        got = work.view_pairs(V, Fc, locs[i], Rs[i], fovs[i], 64, 16)
        assert got == brute_pairs(V, Fc, locs[i], Rs[i], fovs[i], 64, 16)
    w = work.batch_work(V, Fc, (locs, Rs, fovs), range(3), 64, 16)
    assert w["ops"] == w["pairs"] * work.FLOPS_PER_PAIR
    assert w["least_s"] == max(w["ops"] / work.FP32_PEAK, w["bytes"] / work.HBM_BYTES_PER_S)
