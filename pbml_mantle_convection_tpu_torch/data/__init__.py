"""Datasets and snapshot stores: the counterpart of the JAX package's
``data/``."""

from .dataset import (  # noqa: F401,E402
    ConvAEDataset, SnapshotDataset, SnapshotStore, TimePairDataset,
    UnstructuredDataset, select_snapshot_indices)
from .prefetch import prefetch_iter  # noqa: F401,E402
from .synthetic import (  # noqa: F401,E402
    synthetic_store, synthetic_store_memmap)
