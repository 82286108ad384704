"""The reference's entry point: the ten label images of chosen views of one
scene, from the raw scene arrays (vertices, faces, vertex colours)."""
from __future__ import annotations

import numpy as np
import torch

from . import mesh, render


class Reference:
    """One scene on ``device``. ``labels(loc, R, fov)`` -> {name: (H,W[,C])
    int32 numpy array}; the curvature colours of the vertices a view shows
    are fitted when it needs them."""

    def __init__(self, v, f, colors, res: int, tile: int, device):
        self.v, self.f = np.asarray(v, np.float32), np.asarray(f, np.int64)
        self.res, self.tile, self.device = res, tile, torch.device(device)
        self.vn = mesh.vertex_normals(self.v, self.f)
        self.ring = mesh.kring(self.f, self.v.shape[0])
        self.V = torch.as_tensor(self.v, device=self.device)
        self.F = torch.as_tensor(self.f, device=self.device)
        self.normals = torch.as_tensor(self.vn, device=self.device)
        self.colors = torch.as_tensor(np.asarray(colors, np.float32),
                                      device=self.device)

    def labels(self, loc, R, fov, dtype=torch.float32) -> dict:
        dev = self.device
        loc, R, fov = (torch.as_tensor(np.asarray(a, np.float32), device=dev)
                       for a in (loc, R, fov))
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            raster = render.rasterize(self.V, self.F, loc, R, fov, self.res,
                                      self.tile, dtype)
            win = raster[0]
            seen = win[win >= 0].cpu().numpy()
            which = np.unique(self.f[seen].ravel())
            curv = np.zeros_like(self.v)
            curv[which] = mesh.curvature_colors(self.v, self.vn, self.ring, which)
            attrs = (self.normals, self.colors, torch.as_tensor(curv, device=dev))
            out, _ = render.labels(self.V, self.F, attrs, loc, R, fov, self.res,
                                   self.tile, dtype, raster)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        return {k: x.cpu().numpy() for k, x in out.items()}
