"""ray_tpu_torch.data — distributed datasets for TPU training ingest.

Reference analogue: `python/ray/data/__init__.py`.  See
`ray_tpu_torch/data/dataset.py` for the design notes.
"""

from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data.dataset import (ActorPoolStrategy, Dataset,
                                  GroupedData)
from ray_tpu_torch.data.iterator import DataIterator
from ray_tpu_torch.data.preprocessors import (
    BatchMapper,
    Chain,
    Concatenator,
    LabelEncoder,
    MinMaxScaler,
    OneHotEncoder,
    Preprocessor,
    StandardScaler,
)
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_items,
    from_numpy,
    from_pandas,
    range,
    read_binary_files,
    read_images,
    read_tfrecords,
    read_csv,
    read_json,
    read_parquet,
    read_text,
)

__all__ = [
    "ActorPoolStrategy", "BatchMapper", "Block", "BlockAccessor",
    "BlockMetadata", "Chain", "Concatenator", "Dataset", "DataIterator",
    "GroupedData", "LabelEncoder", "MinMaxScaler", "OneHotEncoder",
    "Preprocessor", "StandardScaler",
    "range", "from_items", "from_numpy", "from_pandas", "from_arrow",
    "read_parquet", "read_csv", "read_json", "read_text",
    "read_binary_files",
    "read_images",
    "read_tfrecords",
]
