"""Data pipeline of the port (counterpart of ``esn_tpu/data``): datasets,
the inform statistics, device augmentation, the loader with device
prefetch, the builders, palettes and a PNG writer."""
from .augment import (Augment, Draws, make_augment_fn,  # noqa: F401
                      make_eval_transform, normalize)
from .builders import build_dataset_test, build_dataset_train  # noqa: F401
from .datasets import (CAMVID, CITYSCAPES, SPECS, DatasetSpec,  # noqa: F401
                       ManifestDataset, SyntheticDataset, get_spec,
                       read_manifest)
from .inform import (collect_stats, compute_class_weights,  # noqa: F401
                     load_or_compute_inform)
from .loader import BatchLoader, device_prefetch  # noqa: F401
from . import palettes  # noqa: F401
