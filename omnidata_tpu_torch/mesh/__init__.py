from .mesh import (
    TriangleMesh,
    compute_normals,
    cube,
    from_arrays,
    room,
    split_long_edges,
    uv_sphere,
)
from .raster import (
    Fragments,
    bbox_words,
    bin_triangles,
    face_screen_bboxes,
    render_view,
    render_view_fused,
    render_views,
    render_views_fused,
    scene_pack,
    tile_candidate_counts,
)
from .raster_kernels import (
    CHUNK_LIST_CAP,
    STAGE_CAP,
    STREAMED_STAGE_CAP,
    decode_winners,
    raster_tiles_chunklist,
    raster_tiles_chunklist_reference,
    raster_tiles_compact,
    raster_tiles_compact_reference,
    raster_tiles_streamed,
    raster_tiles_streamed_reference,
)

__all__ = [
    "TriangleMesh", "compute_normals", "cube", "from_arrays", "room",
    "split_long_edges", "uv_sphere", "Fragments", "bbox_words",
    "bin_triangles", "face_screen_bboxes", "render_view", "render_view_fused",
    "render_views", "render_views_fused", "scene_pack", "tile_candidate_counts",
    "CHUNK_LIST_CAP", "STAGE_CAP", "STREAMED_STAGE_CAP", "decode_winners",
    "raster_tiles_chunklist", "raster_tiles_chunklist_reference",
    "raster_tiles_compact", "raster_tiles_compact_reference",
    "raster_tiles_streamed", "raster_tiles_streamed_reference",
]
