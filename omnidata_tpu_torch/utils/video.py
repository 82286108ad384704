"""Trajectory video assembly (reference: paper_code/make_video.py, over the
smooth-trajectory frames whose view ids are zero-padded frame indices).

``make_video`` assembles point_{p}_view_{t}_domain_{task}.png frames into an
mp4 with ffmpeg when it is on PATH, else into an animated GIF, as
``omnidata_tpu.utils.video.make_video`` does. The GIF is written by this
module's own GIF89a encoder (no PIL): each frame is converted to RGB as
PIL's ``convert("RGB")`` converts the annotator's PNG modes (L, RGB, RGBA and
16-bit greyscale, which saturates at 255) and gets a local palette. A frame
of at most 256 colours is stored exactly; a frame with more is median-cut
to 256 colours, each pixel taking the mean colour of its box, so each of
its channels errs by at most that box's extent on the channel
(``quantize``).
"""
from __future__ import annotations

import glob
import os
import re
import shutil
import struct
import subprocess

import numpy as np

from ..cues.encode import load_png


def make_video(frames_dir: str, task: str, out_path: str, fps: int = 15) -> str:
    """Frames ``frames_dir/point_*_view_*_domain_{task}.png`` in numeric
    (point, view) order -> ``out_path`` (mp4 through ffmpeg's concat
    demuxer, each frame 1/fps s) or, without ffmpeg, ``<out_path stem>.gif``
    (each frame int(1000 / fps) ms, looping). Returns the path written;
    raises FileNotFoundError when no frame matches."""
    pattern = os.path.join(frames_dir, f"point_*_view_*_domain_{task}.png")

    def order_key(p):
        # numeric (point, view) order: lexical order puts point_10 before
        # point_2 (view ids are zero-padded, point ids are not)
        m = re.search(r"point_(\d+)_view_(\d+)_", os.path.basename(p))
        return (int(m.group(1)), int(m.group(2))) if m else (1 << 30, p)

    frames = sorted(glob.glob(pattern), key=order_key)
    if not frames:
        raise FileNotFoundError(f"no frames matching {pattern}")
    if shutil.which("ffmpeg"):
        list_file = os.path.join(frames_dir, f"_{task}_frames.txt")
        with open(list_file, "w") as fh:
            for f in frames:
                fh.write(f"file '{os.path.abspath(f)}'\nduration {1.0/fps}\n")
        subprocess.run(
            ["ffmpeg", "-y", "-f", "concat", "-safe", "0", "-i", list_file,
             "-pix_fmt", "yuv420p", out_path],
            check=True, capture_output=True,
        )
        os.remove(list_file)
        return out_path
    gif = os.path.splitext(out_path)[0] + ".gif"
    write_gif(gif, [to_rgb(load_png(f)) for f in frames],
              duration_ms=int(1000 / fps), loop=0)
    return gif


def to_rgb(arr: np.ndarray) -> np.ndarray:
    """A decoded PNG (``cues.encode.load_png``) -> (H,W,3) uint8, as PIL's
    ``convert("RGB")`` converts it: L repeated, RGBA without its alpha,
    16-bit greyscale clipped to 255 and repeated."""
    if arr.ndim == 2 and arr.dtype == np.uint16:
        arr = np.minimum(arr, 255).astype(np.uint8)
    if arr.ndim == 2 and arr.dtype == np.uint8:
        return np.repeat(arr[..., None], 3, -1)
    if arr.ndim == 3 and arr.dtype == np.uint8 and arr.shape[2] in (3, 4):
        return np.ascontiguousarray(arr[..., :3])
    raise ValueError(f"no RGB conversion for a {arr.dtype} {arr.shape} frame")


def quantize(rgb: np.ndarray, max_colors: int = 256):
    """(H,W,3) uint8 -> (palette (n,3) uint8, indices (H,W) uint8), n <=
    max_colors. Exact when the frame has at most max_colors colours; else
    median cut over its distinct colours weighted by pixel count: the box
    with the widest channel is split at that channel's weighted median
    until there are max_colors boxes, and each box's colours map to their
    weighted mean, rounded."""
    colors, inverse, counts = np.unique(rgb.reshape(-1, 3), axis=0,
                                        return_inverse=True, return_counts=True)
    inverse = inverse.reshape(rgb.shape[:2])
    if len(colors) <= max_colors:
        return colors.astype(np.uint8), inverse.astype(np.uint8)
    colors = colors.astype(np.int64)

    def span(b):
        return colors[b].max(0) - colors[b].min(0)

    boxes = [np.arange(len(colors))]
    spans = [span(boxes[0])]
    while len(boxes) < max_colors:
        i = int(np.argmax([s.max() for s in spans]))
        if spans[i].max() == 0:
            break
        b = boxes[i]
        ch = int(np.argmax(spans[i]))
        b = b[np.argsort(colors[b, ch], kind="stable")]
        cum = np.cumsum(counts[b])
        cut = min(max(int(np.searchsorted(cum, cum[-1] / 2.0)) + 1, 1), len(b) - 1)
        boxes[i:i + 1] = [b[:cut], b[cut:]]
        spans[i:i + 1] = [span(b[:cut]), span(b[cut:])]
    box_of = np.empty(len(colors), np.int64)
    palette = np.empty((len(boxes), 3), np.uint8)
    for j, b in enumerate(boxes):
        box_of[b] = j
        w = counts[b].astype(np.float64)
        palette[j] = np.round((colors[b] * w[:, None]).sum(0) / w.sum())
    return palette, box_of[inverse].astype(np.uint8)


def _lzw(indices: bytes, min_size: int) -> bytes:
    """GIF's variable-width LZW of the index stream, least significant bit
    first, with a clear code first and whenever the 4096-entry table fills."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nbits = 0
    size, next_code, table = min_size + 1, eoi + 1, {}

    def emit(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    emit(clear)
    prefix = indices[0]
    for k in indices[1:]:
        key = (prefix << 8) | k
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        table[key] = next_code
        next_code += 1
        if next_code > (1 << size) and size < 12:
            size += 1
        if next_code == 4096:
            emit(clear)
            size, next_code, table = min_size + 1, eoi + 1, {}
        prefix = k
    emit(prefix)
    emit(eoi)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def write_gif(path: str, frames: list, duration_ms: int, loop: int = 0) -> None:
    """Animated GIF89a of (H,W,3) uint8 frames of one size: the NETSCAPE2.0
    loop extension (loop 0 = forever), then per frame a graphic control
    extension with the delay (duration_ms // 10 hundredths of a second, as
    PIL writes it) and a local palette (``quantize``)."""
    H, W = frames[0].shape[:2]
    out = [b"GIF89a", struct.pack("<HHBBB", W, H, 0, 0, 0),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\0"]
    for rgb in frames:
        if rgb.shape[:2] != (H, W):
            raise ValueError(f"frame {rgb.shape[:2]} differs from the first {(H, W)}")
        palette, idx = quantize(rgb)
        bits = max(1, int(len(palette) - 1).bit_length())
        table = np.zeros((1 << bits, 3), np.uint8)
        table[:len(palette)] = palette
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", duration_ms // 10) + b"\0\0")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0x80 | (bits - 1)))
        out.append(table.tobytes())
        min_size = max(2, bits)
        out.append(bytes([min_size]) + _sub_blocks(_lzw(idx.tobytes(), min_size)))
    out.append(b"\x3b")
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
