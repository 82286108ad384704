"""omnidata_tpu_torch.utils.video.make_video against the JAX package's
(omnidata_tpu.utils.video, whose GIF branch uses PIL), on frames in each
PNG mode the annotator writes: RGB, RGBA, L and 16-bit greyscale.

- ffmpeg branch: a fake ``ffmpeg`` first on PATH records its argv and the
  concat list; both packages give the same argv and list text.
- GIF branch (no ffmpeg): decoded here by PIL, the same frame count, size,
  per-frame duration and loop as JAX's GIF; every frame of at most 256
  colours equals PIL's ``convert("RGB")`` of its PNG exactly; a frame with
  more is median-cut, each channel within its box's extent of the source
  (``quantize``'s stated error).
- ``to_rgb`` equals PIL's ``convert("RGB")`` bit for bit in every mode.
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

import omnidata_tpu.utils.video as jvideo
import omnidata_tpu_torch.utils.video as tvideo
from omnidata_tpu_torch.cues.encode import load_png, save_png

FPS = 15

torch.set_num_threads(1)


def _frames(d, task, n_colours=None, seed=0):
    """Frames of one task at (point, view) = (2, 0..1), (10, 0): numeric
    order differs from lexical."""
    rng = np.random.RandomState(seed)
    os.makedirs(d, exist_ok=True)
    for p, v in ((10, 0), (2, 1), (2, 0)):
        if task == "rgb":
            pal = rng.randint(0, 256, (n_colours, 3)).astype(np.uint8)
            arr = pal[rng.randint(0, n_colours, (24, 40))]
        elif task == "rgba":
            arr = rng.randint(0, 256, (24, 40, 4)).astype(np.uint8) // 64 * 64
        elif task == "mask":
            arr = (rng.rand(24, 40) > 0.5).astype(np.uint8) * 255
        else:  # 16-bit depth-like codes, many above 255
            arr = rng.randint(0, 600, (24, 40)).astype(np.uint16)
        save_png(os.path.join(d, f"point_{p}_view_{v:04d}_domain_{task}.png"), arr)
    return sorted(os.listdir(d))


def _gif(path):
    im = Image.open(path)
    frames = [(np.asarray(f.convert("RGB")), f.info.get("duration"))
              for f in ImageSequence.Iterator(im)]
    return frames, im.info.get("loop"), im.size


ORDER = ["point_2_view_0000", "point_2_view_0001", "point_10_view_0000"]


@pytest.mark.parametrize("task, n_colours", [("rgb", 40), ("rgb", 256),
                                             ("rgba", None), ("mask", None),
                                             ("depth", None)])
def test_gif_matches_jax_and_pil(tmp_path, monkeypatch, task, n_colours):
    d = str(tmp_path / "frames")
    _frames(d, task, n_colours)
    monkeypatch.setattr(shutil, "which", lambda _: None)  # both modules: no ffmpeg
    got = tvideo.make_video(d, task, str(tmp_path / "port.mp4"), fps=FPS)
    want = jvideo.make_video(d, task, str(tmp_path / "jax.mp4"), fps=FPS)
    assert got == str(tmp_path / "port.gif") and want == str(tmp_path / "jax.gif")
    gframes, gloop, gsize = _gif(got)
    wframes, wloop, wsize = _gif(want)
    assert (len(gframes), gloop, gsize) == (len(wframes), wloop, wsize) == (3, 0, (40, 24))
    assert [g[1] for g in gframes] == [w[1] for w in wframes] == [60] * 3
    for (frame, _), name in zip(gframes, ORDER):
        png = os.path.join(d, f"{name}_domain_{task}.png")
        np.testing.assert_array_equal(frame, np.asarray(Image.open(png).convert("RGB")))


def test_to_rgb_equals_pil_convert(tmp_path):
    rng = np.random.RandomState(3)
    arrays = [rng.randint(0, 256, (5, 7, 3)).astype(np.uint8),
              rng.randint(0, 256, (5, 7, 4)).astype(np.uint8),
              rng.randint(0, 256, (5, 7)).astype(np.uint8),
              rng.randint(0, 65536, (5, 7)).astype(np.uint16),
              np.array([[0, 1, 254, 255, 256, 65535]], np.uint16)]
    for i, a in enumerate(arrays):
        p = str(tmp_path / f"{i}.png")
        save_png(p, a)
        np.testing.assert_array_equal(tvideo.to_rgb(load_png(p)),
                                      np.asarray(Image.open(p).convert("RGB")))
    with pytest.raises(ValueError, match="no RGB conversion"):
        tvideo.to_rgb(np.zeros((2, 2, 2), np.uint8))


def test_many_colours_are_median_cut_within_box_extent(tmp_path):
    """4,096 random colours: 256 palette entries, each pixel's channels
    within the extent of the colours its palette entry stands for; the GIF
    decodes to exactly palette[indices]."""
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    palette, idx = tvideo.quantize(rgb)
    assert palette.shape == (256, 3) and idx.shape == (64, 64)
    err = np.abs(palette[idx].astype(int) - rgb)
    for j in range(len(palette)):
        members = rgb[idx == j].astype(int)
        extent = members.max(0) - members.min(0)
        assert (err[idx == j] <= extent).all()
    assert err.mean() < 16
    path = str(tmp_path / "q.gif")
    tvideo.write_gif(path, [rgb, rgb[::-1]], duration_ms=40)
    frames, loop, _ = _gif(path)
    np.testing.assert_array_equal(frames[0][0], palette[idx])
    assert [f[1] for f in frames] == [40, 40] and loop == 0


FAKE_FFMPEG = r'''#!{python}
import json, sys
args = sys.argv[1:]
with open(args[args.index("-i") + 1]) as fh:
    listing = fh.read()
with open({log!r}, "a") as fh:
    fh.write(json.dumps([args, listing]) + "\n")
open(args[-1], "wb").close()
'''


def test_ffmpeg_argv_and_list_match_jax(tmp_path, monkeypatch):
    d = str(tmp_path / "frames")
    _frames(d, "rgb", 40)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "ffmpeg.jsonl"
    exe = bin_dir / "ffmpeg"
    exe.write_text(FAKE_FFMPEG.format(python=sys.executable, log=str(log)))
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    out = str(tmp_path / "v.mp4")
    assert tvideo.make_video(d, "rgb", out, fps=FPS) == out
    assert jvideo.make_video(d, "rgb", out, fps=FPS) == out
    (targs, tlist), (jargs, jlist) = (json.loads(x) for x in log.read_text().splitlines())
    assert targs == jargs and tlist == jlist
    assert targs[:6] == ["-y", "-f", "concat", "-safe", "0", "-i"]
    assert [line.split("/")[-1] for line in tlist.splitlines()[::2]] == [
        f"{n}_domain_rgb.png'" for n in ORDER]
    assert sorted(os.listdir(d)) == sorted(f"{n}_domain_rgb.png" for n in ORDER)


def test_no_frames_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="no frames"):
        tvideo.make_video(str(tmp_path), "rgb", str(tmp_path / "v.mp4"))


def test_utils_exports_match_jax(tmp_path):
    """The port's utils export what the JAX package's do; DeviceTrace writes
    a Chrome trace of what ran inside it."""
    import torch

    import omnidata_tpu.utils as jutils
    import omnidata_tpu_torch.utils as tutils

    names = {"Profiler", "DeviceTrace", "make_video"}
    assert names <= set(dir(jutils)) and names <= set(dir(tutils))
    with tutils.DeviceTrace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
