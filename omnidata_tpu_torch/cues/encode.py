"""Label encodings: the reference's compositor/PNG conventions.

Depth: 16-bit with sensitivity max_m / 2^16 (1/512 m at the default 128 m);
invalid pixels saturate to 65535. mask_valid: 255 valid / 0 invalid.
Normals: camera-space n -> (0.5 - 0.5nx, 0.5 + 0.5ny, 0.5 + 0.5nz).

Rounding is round-half-even (``torch.round``, as ``jnp.round``). Values are
computed in float32 and cast once at the end: torch.uint16 has few
operators, so it is an output type only.

PNG files are written and read with ``zlib`` and ``struct`` (no imaging
library): the writer emits 8-bit grey, 8-bit RGB and 16-bit grey
(big-endian samples) with filter type 0; the reader takes non-interlaced
8-bit grey, grey+alpha, RGB, RGBA and palette images and 16-bit grey and
RGB, with all five row filters, so it reads what other encoders write.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

DEPTH_MAX_METERS = 128.0
U16_MAX = 65535


def _as_u16(code: torch.Tensor) -> torch.Tensor:
    """Integral float32 codes in [0, 65535] -> uint16."""
    return code.to(torch.int32).to(torch.uint16)


def encode_depth_16bit(depth_m: torch.Tensor, valid: torch.Tensor,
                       max_meters: float = DEPTH_MAX_METERS) -> torch.Tensor:
    """Metric depth (...,H,W) -> uint16 codes; invalid -> 65535."""
    code = torch.round(torch.clamp(depth_m / max_meters, 0.0, 1.0) * U16_MAX)
    return _as_u16(torch.where(valid, code, float(U16_MAX)))


def decode_depth_16bit(code: torch.Tensor,
                       max_meters: float = DEPTH_MAX_METERS):
    """uint16 codes -> (depth_m float32, valid); 65535 marks invalid."""
    code = code.to(torch.int32)
    return code.to(torch.float32) * (max_meters / U16_MAX), code != U16_MAX


def mask_valid_image(valid: torch.Tensor) -> torch.Tensor:
    """Boolean valid mask -> 8-bit mask image (255 valid / 0 invalid)."""
    return valid.to(torch.uint8) * 255


def encode_normals_color(n_cam: torch.Tensor,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """Camera-frame unit normals (...,3) -> float colors in [0,1], R channel
    inverted; no-hit pixels are 0.5 grey."""
    col = torch.stack(
        [0.5 - 0.5 * n_cam[..., 0], 0.5 + 0.5 * n_cam[..., 1],
         0.5 + 0.5 * n_cam[..., 2]], -1)
    col = torch.clamp(col, 0.0, 1.0)
    if valid is not None:
        col = torch.where(valid[..., None], col, 0.5)
    return col


def decode_normals_color(col: torch.Tensor) -> torch.Tensor:
    """Inverse of ``encode_normals_color``: colours in [0,1] -> unit camera
    normals."""
    n = torch.stack([-(2.0 * col[..., 0] - 1.0), 2.0 * col[..., 1] - 1.0,
                     2.0 * col[..., 2] - 1.0], -1)
    norm = torch.sqrt(n[..., 0:1] * n[..., 0:1] + n[..., 1:2] * n[..., 1:2]
                      + n[..., 2:3] * n[..., 2:3])
    return n / torch.clamp(norm, min=1e-12)


def img_as_uint16(x: torch.Tensor) -> torch.Tensor:
    """skimage.img_as_uint for floats in [0,1]: round(x * 65535)."""
    return _as_u16(torch.round(torch.clamp(x, 0.0, 1.0) * U16_MAX))


def img_as_uint8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255).to(torch.uint8)


# -------- PNG files ---------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(arr: np.ndarray, level: int = 6) -> bytes:
    """(H,W) uint8 or uint16 grey, or (H,W,3) uint8 RGB, or (H,W,4) uint8
    RGBA -> PNG bytes."""
    arr = np.asarray(arr)
    if arr.ndim == 2 and arr.dtype == np.uint8:
        depth, ctype = 8, 0
    elif arr.ndim == 2 and arr.dtype == np.uint16:
        depth, ctype, arr = 16, 0, arr.astype(">u2")
    elif arr.ndim == 3 and arr.shape[2] in (3, 4) and arr.dtype == np.uint8:
        depth, ctype = 8, 2 if arr.shape[2] == 3 else 6
    else:
        raise ValueError(f"cannot write a PNG from {arr.dtype} {arr.shape}: "
                         "need (H,W) uint8/uint16 or (H,W,3|4) uint8")
    H, W = arr.shape[:2]
    rows = np.ascontiguousarray(arr).view(np.uint8).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], 1)  # filter 0
    ihdr = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _png_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters -> (H, stride) uint8."""
    data = np.frombuffer(raw, np.uint8)
    if data.size < H * (stride + 1):
        raise ValueError("truncated PNG image data")
    data = data[: H * (stride + 1)].reshape(H, stride + 1)
    ftypes, rows = data[:, 0], data[:, 1:]
    if not ftypes.any():
        return rows.copy()
    out = np.zeros((H, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        f, row = int(ftypes[y]), rows[y]
        if f == 0:
            cur = row.copy()
        elif f == 1:  # Sub: running sum per byte lane, modulo 256
            lanes = row.reshape(-1, bpp).astype(np.int64)
            cur = (np.cumsum(lanes, 0) & 255).astype(np.uint8).ravel()
        elif f == 2:  # Up
            cur = row + prior
        elif f in (3, 4):  # Average, Paeth: sequential along the row
            r, p = bytearray(row.tobytes()), prior.tobytes()
            for i in range(stride):
                a = r[i - bpp] if i >= bpp else 0
                c = p[i - bpp] if i >= bpp else 0
                pred = (a + p[i]) >> 1 if f == 3 else _paeth(a, p[i], c)
                r[i] = (r[i] + pred) & 255
            cur = np.frombuffer(bytes(r), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {f}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(buf: bytes, expand_palette: bool = True) -> np.ndarray:
    """PNG bytes -> (H,W) or (H,W,C) uint8 / uint16 array (palette images
    expand to RGB, or give their (H,W) indices as PIL's arrays do)."""
    if buf[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, plte, hdr = 8, [], None, None
    while pos + 8 <= len(buf):
        n, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"PLTE":
            plte = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS or depth not in (8, 16) or interlace \
            or (ctype == 3 and (depth != 8 or plte is None)):
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    C = _CHANNELS[ctype]
    bpp = C * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), H, W * bpp, bpp)
    if depth == 16:
        arr = rows.view(">u2").astype(np.uint16).reshape(H, W, C)
    else:
        arr = rows.reshape(H, W, C)
    if ctype == 3 and expand_palette:
        return plte[arr[..., 0]]
    return arr[..., 0] if C == 1 else arr


def save_png(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(arr))


def load_png(path: str, expand_palette: bool = True) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_png(fh.read(), expand_palette)


def load_rgb_u8(path: str) -> np.ndarray:
    """An 8-bit PNG as (H,W,3) uint8 RGB, as PIL's convert("RGB") gives it:
    grey repeated, alpha dropped."""
    a = load_png(path)
    if a.dtype != np.uint8:
        raise ValueError(f"{path}: need an 8-bit PNG, not {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    return np.ascontiguousarray(
        np.repeat(a[..., :1], 3, -1) if a.shape[2] in (1, 2) else a[..., :3])


def load_rgb_float(path: str) -> np.ndarray:
    """An 8-bit PNG as (H,W,3) float32 RGB in [0,1]: the texture loader's
    conversion."""
    return load_rgb_u8(path).astype(np.float32) / 255.0
