from .pipeline import DEVICE_MODALITIES, annotate_views

__all__ = ["DEVICE_MODALITIES", "annotate_views"]
