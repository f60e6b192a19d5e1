"""Images as arrays, and PNG files written with ``zlib`` alone.

The port draws no figure (the card's Python has no matplotlib): a view is
one float32 RGB array in [0, 1] with its tiles on a grid, each tile inside
a ``BORDER``-pixel frame (white, or the red / green border of the JAX
package's ``viz.hooks._grid``), ``PAD`` white pixels between frames.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["write_png", "compose", "tile_origin", "curve_tile", "BORDER", "PAD"]

BORDER = 3
PAD = 2
COLORS = {"red": (1.0, 0.0, 0.0), "green": (0.0, 1.0, 0.0)}
CURVE = (0.0, 0.0, 1.0)
AXES = (0.5, 0.5, 0.5)

Cell = Tuple[np.ndarray, Optional[str]]


def write_png(path, images: np.ndarray, pad: int = 2) -> None:
    """Write [N, H, W, C] images in [0, 1] side by side, ``pad`` white
    pixels apart, as one 8-bit grey (C = 1) or RGB PNG."""
    n, h, w, c = images.shape
    grid = np.ones((h, n * w + (n - 1) * pad, c), np.float32)
    for i, img in enumerate(images):
        grid[:, i * (w + pad):i * (w + pad) + w] = img
    pixels = np.round(np.clip(grid, 0.0, 1.0) * 255.0).astype(np.uint8)
    rows = b"".join(b"\x00" + row.tobytes() for row in pixels)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", grid.shape[1], h, 8, 0 if c == 1 else 2, 0, 0, 0)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                           + chunk(b"IDAT", zlib.compress(rows, 9)) + chunk(b"IEND", b""))


def tile_origin(row: int, col: int, h: int, w: int) -> Tuple[int, int]:
    """(y, x) of the top-left pixel of tile (row, col) of h x w tiles."""
    return (row * (h + 2 * BORDER + PAD) + BORDER, col * (w + 2 * BORDER + PAD) + BORDER)


def compose(rows: Sequence[Sequence[Cell]]) -> np.ndarray:
    """One RGB view [H, W, 3] of rows of (tile [h, w, C] in [0, 1], border
    color or None) cells; a grey tile (C = 1) fills all three channels."""
    h, w = rows[0][0][0].shape[:2]
    n_rows, n_cols = len(rows), max(len(r) for r in rows)
    view = np.ones((n_rows * (h + 2 * BORDER + PAD) - PAD,
                    n_cols * (w + 2 * BORDER + PAD) - PAD, 3), np.float32)
    for i, row in enumerate(rows):
        for j, (tile, border) in enumerate(row):
            y, x = tile_origin(i, j, h, w)
            if border is not None:
                view[y - BORDER:y + h + BORDER, x - BORDER:x + w + BORDER] = COLORS[border]
            view[y:y + h, x:x + w] = tile
    return view


def curve_tile(values: np.ndarray, h: int, w: int, color=CURVE, tile=None,
               span=None) -> np.ndarray:
    """``values`` as a line on an h x w white tile: index along x, value
    along y (the largest at the top), over grey axes on the left and bottom.
    ``tile`` draws onto a tile already made (more curves on one panel),
    ``span`` (lo, hi) fixes the y range (default: the values' own), and
    ``color`` is the line's RGB."""
    if tile is None:
        tile = np.ones((h, w, 3), np.float32)
        tile[:, 0] = AXES
        tile[-1, :] = AXES
    v = np.asarray(values, np.float64)
    lo, hi = (float(v.min()), float(v.max())) if span is None else map(float, span)
    xs = np.linspace(1, w - 1, len(v))
    ys = (h - 2) * (1.0 - (v - lo) / (hi - lo)) if hi > lo else np.full(len(v), (h - 2) / 2)
    # each segment sampled densely enough to leave no gap between pixels
    k = 2 * max(h, w)
    for a in range(len(v) - 1):
        f = np.linspace(0.0, 1.0, k)
        cols = np.round(xs[a] + f * (xs[a + 1] - xs[a])).astype(int)
        rws = np.round(ys[a] + f * (ys[a + 1] - ys[a])).astype(int)
        tile[np.clip(rws, 0, h - 2), np.clip(cols, 1, w - 1)] = color
    if len(v) == 1:
        tile[int(round(ys[0])), int(round(xs[0]))] = color
    return tile
