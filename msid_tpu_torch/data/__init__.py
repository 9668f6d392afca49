"""Host-side data of the PyTorch port: TIFF I/O, the EuroSAT-MS reader and
its synthetic stand-in, the batch loader and the device tile cache."""

from msid_tpu_torch.data.dataset import (
    EuroSATMultiSpectral,
    SyntheticEuroSAT,
    build_dataset,
)
from msid_tpu_torch.data.pipeline import (
    BatchLoader,
    DeviceCachedLoader,
    get_dataloaders,
    get_test_dataloader,
)
from msid_tpu_torch.data.tiff import read_tiff, write_tiff

__all__ = [
    "BatchLoader",
    "DeviceCachedLoader",
    "EuroSATMultiSpectral",
    "SyntheticEuroSAT",
    "build_dataset",
    "get_dataloaders",
    "get_test_dataloader",
    "read_tiff",
    "write_tiff",
]
