"""The trainers' data path: the filesystem dataset over annotator outputs,
its PIL-free transforms, the prefetching loaders, the training masks, the
packed sample cache, the component datasets (hypersim among them), scene
metadata for multiview sampling, instance helpers and the starter-dataset
downloader (``python -m omnidata_tpu_torch.data.download``)."""
from .masks import build_mask, dilate_invalid
from .task_configs import task_parameters, PIX_TO_PIX_TASKS, SINGLE_IMAGE_TASKS
from .transforms import get_transform, default_loader
from .dataset import OmnidataDataset, Options, component_weighted_indices
from .packed_cache import PackedDataset, build_packed_cache
from .scene_metadata import (
    BuildingMetadata,
    BuildingMultiviewMetadata,
    CenterVisibleMultiviewSampler,
    OverlapMultiviewSampler,
)
from .splits import get_splits, subset_ladder, flat_split_to_spaces, SUBSETS
from .segment_instance import (
    random_colors,
    extract_instance_masks,
    masks_to_bboxes,
    fragments_to_instances,
    overlay_instances,
)
from .components import COMPONENTS, Component, make_component_dataset, normal_world_to_cam, NYU40_CLASSES
