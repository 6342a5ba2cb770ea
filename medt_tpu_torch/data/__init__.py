"""Data of the port: PNG codec, datasets, joint transforms, the prefetching
loader and synthetic sets (numpy and the standard library only)."""
from .dataset import Image2D, ImageToImage2D
from .loader import DataLoader, collate, to_device
from .png import read_png, write_mask_png, write_png
from .synthetic import InMemoryDataset, blob_batch, make_png_dataset
from .transforms import JointTransform2D, to_float01

__all__ = [
    "DataLoader",
    "Image2D",
    "ImageToImage2D",
    "InMemoryDataset",
    "JointTransform2D",
    "blob_batch",
    "collate",
    "make_png_dataset",
    "read_png",
    "to_device",
    "to_float01",
    "write_mask_png",
    "write_png",
]
