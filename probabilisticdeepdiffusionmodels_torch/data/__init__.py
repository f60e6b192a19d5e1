from .datasets import DATA_DIR, ArrayDataset, DataLoader, get_dataset
from .transforms import NORMALIZATIONS, Transform, unnormalize
