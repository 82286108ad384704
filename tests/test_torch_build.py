"""omnidata_tpu_torch._build without nvcc: a library is keyed by its source,
every header in csrc/ and the flags, so an edited shared header rebuilds
every kernel that may include it."""
from omnidata_tpu_torch import _build


def test_digest_covers_the_shared_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\nint x;\n')
    (tmp_path / "common.cuh").write_text("constexpr int kA = 1;\n")
    first = _build.source_digest("k")
    assert _build.source_digest("k") == first  # stable
    (tmp_path / "common.cuh").write_text("constexpr int kA = 2;\n")
    edited = _build.source_digest("k")
    assert edited != first
    (tmp_path / "k.cu").write_text('#include "common.cuh"\nint y;\n')
    assert _build.source_digest("k") not in (first, edited)
    assert _build.library_path("k").name == f"libk-{_build.source_digest('k')}.so"


def test_repository_sources_share_the_header():
    """Both kernel sources include raster_common.cuh, which the digest
    covers."""
    for name in ("raster_chunklist", "raster_compact"):
        src = (_build.SRC_DIR / f"{name}.cu").read_text()
        assert '#include "raster_common.cuh"' in src
        assert len(_build.source_digest(name)) == 16
