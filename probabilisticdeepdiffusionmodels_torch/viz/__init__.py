from .hooks import VisualizationCallback
from .image import compose, curve_tile, tile_origin, write_png
