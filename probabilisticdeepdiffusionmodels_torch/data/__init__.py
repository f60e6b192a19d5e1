from .datasets import DATA_DIR, ArrayDataset, DataLoader, get_dataset
from .device_loader import DeviceDataLoader
from .transforms import NORMALIZATIONS, Transform, unnormalize
