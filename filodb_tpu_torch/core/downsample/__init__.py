"""Downsampling: raw chunks rolled up for long-retention queries.

Port of ``filodb_tpu/core/downsample/``: the rollups and the streaming and
batch downsamplers (``downsampler.py``) and the read store over the ds
datasets (``dsstore.py``).
"""

from filodb_tpu_torch.core.downsample.downsampler import (  # noqa: F401
    DownsamplerJob,
    ShardDownsampler,
    downsample_partition,
    downsample_samples,
    ds_dataset_name,
)
from filodb_tpu_torch.core.downsample.dsstore import (  # noqa: F401
    DownsampledTimeSeriesStore,
    ReadOnlyShard,
    ReadOnlyStore,
)
