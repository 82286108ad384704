from .distributed import annotate_views_sharded, make_annotate_mesh
from .pipeline import DEVICE_MODALITIES, annotate_view, annotate_views

__all__ = ["DEVICE_MODALITIES", "annotate_view", "annotate_views",
           "annotate_views_sharded", "make_annotate_mesh"]
