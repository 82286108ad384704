"""The port's mesh loaders, mesh conversion and PNG files against the JAX
package. Tolerance: exact. The loaders are the same numpy code, so OBJ,
PLY (ascii and binary), OBJ+MTL, textured OBJ and subdivide_mesh give
arrays equal to the JAX package's (the inputs of tests/test_mesh.py's
loader tests). The port writes PNGs without PIL: PIL must decode them to
the array written (8-bit grey, RGB, 16-bit grey), and the port must decode
PIL-written files exactly, whatever row filters PIL chose."""
import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from omnidata_tpu.cues.encode import load_png as j_load_png
from omnidata_tpu.cues.encode import save_png as j_save_png
from omnidata_tpu.mesh import mesh as jm
from omnidata_tpu.utils.convert_mesh import write_ply as j_write_ply
from omnidata_tpu_torch.cues import encode as tenc
from omnidata_tpu_torch.mesh import mesh as tm
from omnidata_tpu_torch.utils import convert_mesh as tconv

from _torch_port_util import MESH_FIELDS

torch.set_num_threads(1)

QUADS_PLY_HEAD = ("ply\nformat binary_little_endian 1.0\nelement vertex 4\n"
                  "property float x\nproperty float y\nproperty float z\n"
                  "element face 2\nproperty list uchar int vertex_indices\n"
                  "property int object_id\nend_header\n").encode()
QUAD_VERTS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)


def _assert_same_mesh(tmesh, jmesh):
    assert tmesh.num_faces == jmesh.num_faces
    for k in MESH_FIELDS:
        j, t = getattr(jmesh, k), getattr(tmesh, k)
        assert (j is None) == (t is None), k
        if j is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=k)
            assert t.numpy().dtype == np.asarray(j).dtype, k


def _write(tmp_path, name, data):
    p = tmp_path / name
    (p.write_bytes if isinstance(data, bytes) else p.write_text)(data)
    return str(p)


def test_obj_matches_jax(tmp_path):
    p = _write(tmp_path, "tri.obj",
               "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3\nf 2 4 3\n")
    _assert_same_mesh(tm.load_obj(p), jm.load_obj(p))
    quad = _write(tmp_path, "quad.obj",  # polygon fan, the walk parser
                  "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0\n"
                  "f 1 2 3 5 4\n")
    _assert_same_mesh(tm.load_obj(quad), jm.load_obj(quad))


def test_textured_obj_matches_jax(tmp_path):
    """tests/test_mesh.py's checker-textured quad: uvs per vertex and the
    sibling PNG texture (written by PIL, read without it)."""
    tex = np.zeros((64, 64, 3), np.uint8)
    tex[:32, :32] = (255, 0, 0)
    tex[32:, 32:] = (0, 255, 0)
    Image.fromarray(tex).save(tmp_path / "m.png")
    p = _write(tmp_path, "m.obj",
               "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
               "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
               "f 1/1 2/2 3/3\nf 1/1 3/3 4/4\n")
    tmesh = tm.load_obj(p)
    assert tmesh.texture is not None and tmesh.vertex_uvs is not None
    _assert_same_mesh(tmesh, jm.load_obj(p))


@pytest.mark.parametrize("labels", [False, True])
def test_ascii_ply_matches_jax(tmp_path, labels):
    if labels:  # tests/test_mesh.py's semantic ply: a face label column
        text = ("ply\nformat ascii 1.0\nelement vertex 4\n"
                "property float x\nproperty float y\nproperty float z\n"
                "element face 2\nproperty list uchar int vertex_indices\n"
                "property int object_id\nend_header\n"
                "0 0 0\n1 0 0\n0 1 0\n1 1 0\n3 0 1 2 7\n3 1 3 2 9\n")
    else:  # vertex colours
        text = ("ply\nformat ascii 1.0\nelement vertex 3\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "element face 1\nproperty list uchar int vertex_indices\nend_header\n"
                "0 0 0 255 0 0\n1 0 0 0 255 0\n0 1 0 0 0 255\n3 0 1 2\n")
    p = _write(tmp_path, "a.ply", text)
    tmesh = tm.load_ply(p)
    _assert_same_mesh(tmesh, jm.load_ply(p))
    assert (tmesh.face_labels is not None) == labels


@pytest.mark.parametrize("mixed", [False, True])
def test_binary_ply_matches_jax(tmp_path, mixed):
    """Uniform triangles (the record-array path) and a quad + triangle (the
    walk), each with a label column."""
    body = b"".join(struct.pack("<3f", *p) for p in QUAD_VERTS)
    if mixed:
        body += struct.pack("<B4ii", 4, 0, 1, 3, 2, 5)
        body += struct.pack("<B3ii", 3, 0, 2, 3, 6)
    else:
        body += struct.pack("<B3ii", 3, 0, 1, 2, 7)
        body += struct.pack("<B3ii", 3, 1, 3, 2, 9)
    p = _write(tmp_path, "b.ply", QUADS_PLY_HEAD + body)
    tmesh = tm.load_ply(p)
    assert tmesh.num_faces == (3 if mixed else 2)
    _assert_same_mesh(tmesh, jm.load_ply(p))


def test_written_ply_round_trips_like_jax(tmp_path):
    """write_ply output (binary and ascii, with colours) is byte-identical
    to the JAX package's and loads to the same arrays."""
    r = tm.room(size=4.0, height=2.5)
    v, f = r.vertices.numpy(), r.faces[: r.num_faces].numpy()
    colors = np.random.RandomState(0).rand(len(v), 3)
    for binary in (True, False):
        tp, jp = str(tmp_path / f"t{binary}.ply"), str(tmp_path / f"j{binary}.ply")
        tconv.write_ply(tp, v, f, vertex_colors=colors, binary=binary)
        j_write_ply(jp, v, f, vertex_colors=colors, binary=binary)
        assert open(tp, "rb").read() == open(jp, "rb").read()
        _assert_same_mesh(tm.load_ply(tp), jm.load_ply(jp))
    obj = str(tmp_path / "m.obj")
    tconv.write_obj(obj, v, f)
    _assert_same_mesh(tm.load_obj(obj), jm.load_obj(obj))
    ply2 = str(tmp_path / "m2.ply")
    tconv.main([obj, ply2])
    _assert_same_mesh(tm.load_ply(ply2), jm.load_obj(obj))


def test_obj_mtl_matches_jax(tmp_path):
    """tests/test_mesh.py's two-material scene: per-face Kd colours and
    trailing-integer labels."""
    _write(tmp_path, "scene.mtl", "newmtl wall_7\nKd 0.9 0.1 0.1\n"
                                  "newmtl floor_3\nKd 0.1 0.8 0.1\n")
    p = _write(tmp_path, "scene.obj",
               "mtllib scene.mtl\n"
               "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
               "v 1 0 0\nv 2 0 0\nv 2 1 0\nv 1 1 0\n"
               "usemtl wall_7\nf 1 2 3\nf 1 3 4\n"
               "usemtl floor_3\nf 5 6 7\nf 5 7 8\n")
    tmesh, tnames = tm.load_obj_mtl(p)
    jmesh, jnames = jm.load_obj_mtl(p)
    assert tnames == jnames == ["wall_7", "floor_3"]
    _assert_same_mesh(tmesh, jmesh)
    assert tm.parse_mtl(str(tmp_path / "scene.mtl")) == jm.parse_mtl(
        str(tmp_path / "scene.mtl"))


def test_subdivide_and_helpers_match_jax():
    c = jm.cube(size=3.0)
    _assert_same_mesh(tm.subdivide_mesh(tm.cube(size=3.0), 1.0),
                      jm.subdivide_mesh(c, 1.0))
    _assert_same_mesh(tm.quad_plane(size=10.0, z=0.5), jm.quad_plane(size=10.0, z=0.5))
    np.testing.assert_array_equal(tm.gathered_triangles(tm.cube(size=3.0)).numpy(),
                                  np.asarray(jm.gathered_triangles(c)))


def _arrays():
    rng = np.random.RandomState(0)
    return {
        "L8": rng.randint(0, 256, (37, 53)).astype(np.uint8),
        "RGB8": rng.randint(0, 256, (37, 53, 3)).astype(np.uint8),
        "L16": rng.randint(0, 65536, (37, 53)).astype(np.uint16),
    }


@pytest.mark.parametrize("kind", ["L8", "RGB8", "L16"])
def test_port_png_decodes_under_pil(tmp_path, kind):
    a = _arrays()[kind]
    p = str(tmp_path / "x.png")
    tenc.save_png(p, a)
    back = np.asarray(Image.open(p))
    if back.dtype == np.int32:  # PIL opens 16-bit grey as I
        back = back.astype(np.uint16)
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back, a)
    np.testing.assert_array_equal(tenc.load_png(p), a)


@pytest.mark.parametrize("kind", ["L8", "RGB8", "L16", "smooth"])
def test_port_load_png_reads_jax_written_pngs(tmp_path, kind):
    """PIL's encoder picks a filter per row; a smooth gradient makes it
    use the predictive ones."""
    if kind == "smooth":
        x = (np.add.outer(np.arange(48), 2 * np.arange(40)) % 256).astype(np.uint8)
        a = np.stack([x, x // 2, 255 - x], -1)
    else:
        a = _arrays()[kind]
    p = str(tmp_path / "j.png")
    j_save_png(p, a)
    got = tenc.load_png(p)
    assert got.dtype == a.dtype
    np.testing.assert_array_equal(got, a)
    np.testing.assert_array_equal(got, j_load_png(p))


def _png_with_filters(img, bpp):
    """A PNG whose rows cycle through filter types 0-4 (forward filters per
    the PNG specification), 8-bit RGB."""
    H, stride = img.shape[0], img.shape[1] * img.shape[2]
    rows = img.reshape(H, stride).astype(np.int64)
    out = []
    for y in range(H):
        f, cur = y % 5, rows[y]
        prior = rows[y - 1] if y else np.zeros(stride, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if f == 0:
            pred = np.zeros(stride, np.int64)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prior
        elif f == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, ul))
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", img.shape[1], H, 8, 2, 0, 0, 0)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


def test_every_row_filter_decodes():
    img = np.random.RandomState(1).randint(0, 256, (10, 7, 3)).astype(np.uint8)
    buf = _png_with_filters(img, 3)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(buf))), img)
    np.testing.assert_array_equal(tenc.decode_png(buf), img)


@pytest.mark.parametrize("mode", ["RGBA", "LA", "P"])
def test_other_colour_types_decode(mode):
    """Texture files may carry alpha or a palette; the texture loader keeps
    RGB."""
    x = (np.add.outer(np.arange(16), np.arange(16)) * 8 % 256).astype(np.uint8)
    im = Image.fromarray(np.stack([x, x.T, 255 - x], -1)).convert(mode)
    bio = io.BytesIO()
    im.save(bio, format="PNG")
    want = np.asarray(im.convert("RGB") if mode == "P" else im)
    np.testing.assert_array_equal(tenc.decode_png(bio.getvalue()), want)


def test_unsupported_png_is_refused(tmp_path):
    with pytest.raises(ValueError, match="not a PNG"):
        tenc.decode_png(b"GIF89a")
    with pytest.raises(ValueError, match="cannot write"):
        tenc.encode_png(np.zeros((4, 4), np.float32))
