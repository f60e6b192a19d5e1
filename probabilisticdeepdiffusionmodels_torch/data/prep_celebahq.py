"""CelebA-HQ offline preparation tools.

PyTorch-port copy of ``probabilisticdeepdiffusionmodels_tpu/data/prep_celebahq.py``,
with the tables read and written by the ``csv`` module where JAX's uses
pandas (the same rows, columns and values), and PIL imported where an image
is touched.  Ports of the reference's prep scripts, every path passed
explicitly (the reference hard-codes /scratch paths at
scripts/prepare_celeba_hq.py:8-9 and resize_images.py:5-7):
  * build_metadata: join the CelebAMask-HQ -> CelebA mapping with the
    original eval partition, carve an extra 3k validation split out of train
    (seed 0, split id 3), join the 40 attributes, write metadata.csv
    (reference scripts/prepare_celeba_hq.py:11-36)
  * resize_images: 1024 -> 256 bilinear into img256/
    (reference scripts/resize_images.py:5-16)
  * copy_splits: materialize train/val directories
    (reference scripts/copy_splits.py:11-27)

Run as:
    python -m probabilisticdeepdiffusionmodels_torch.data.prep_celebahq \\
        build-metadata <celebahq_root> <celeba_anno_dir>
    python -m probabilisticdeepdiffusionmodels_torch.data.prep_celebahq \\
        resize <celebahq_root> [--size 256]
    python -m probabilisticdeepdiffusionmodels_torch.data.prep_celebahq \\
        copy-splits <celebahq_root> <out_dir>
"""

from __future__ import annotations

import csv
import shutil
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["build_metadata", "resize_images", "copy_splits"]

N_EXTRA_VAL = 3000
EXTRA_VAL_SPLIT_ID = 3
EXTRA_VAL_SEED = 0

Table = Tuple[List[str], List[Dict[str, object]]]


def _number(text: str):
    """A field as pandas' reader types it: int, else float, else the text."""
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def _typed(columns: List[str], rows: List[List[str]]) -> Table:
    """Rows of fields, each column typed as a whole (pandas' inference): all
    ints, else all numbers (floats), else text."""
    out = [dict() for _ in rows]
    for j, name in enumerate(columns):
        values = [_number(r[j]) for r in rows]
        if not all(isinstance(v, int) for v in values):
            if all(isinstance(v, (int, float)) for v in values):
                values = [float(v) for v in values]
            else:
                values = [r[j] for r in rows]
        for row, v in zip(out, values):
            row[name] = v
    return columns, out


def _read_whitespace(path: Path, names: Optional[List[str]] = None,
                     header_line: int = 0) -> Table:
    """A whitespace-separated table (pandas' ``sep=r"\\s+"``): the header on
    line ``header_line`` (earlier lines skipped) unless ``names`` are given.
    Rows one field longer than the header carry their key in front, as
    pandas' implicit index; it becomes the column ``index``."""
    lines = [ln.split() for ln in Path(path).read_text().splitlines() if ln.strip()]
    if names is None:
        columns, lines = lines[header_line], lines[header_line + 1:]
    else:
        columns = list(names)
    if lines and len(lines[0]) == len(columns) + 1:
        columns = ["index"] + columns
    return _typed(columns, lines)


def _merge_left(left: Table, right: Table, on: str) -> Table:
    """pandas' ``left.merge(right, on=on, how="left")``: the left rows in
    order, each once per matching right row (or once with the right columns
    missing), the right columns after the left ones."""
    lcols, lrows = left
    rcols, rrows = right
    extra = [c for c in rcols if c != on]
    by_key: Dict[object, List[dict]] = {}
    for r in rrows:
        by_key.setdefault(r[on], []).append(r)
    rows = []
    for row in lrows:
        for match in by_key.get(row[on], [None]):
            merged = dict(row)
            for c in extra:
                merged[c] = None if match is None else match[c]
            rows.append(merged)
    return lcols + extra, rows


def _write_csv(path: Path, table: Table) -> None:
    """``DataFrame.to_csv(index=False)``: a column with a missing value is a
    float column (its ints written as floats), a missing value is empty."""
    columns, rows = table
    floats = {c for c in columns if any(r[c] is None for r in rows)
              and any(isinstance(r[c], (int, float)) for r in rows)}

    def text(c, v):
        if v is None:
            return ""
        return repr(float(v)) if c in floats or isinstance(v, float) else str(v)

    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for r in rows:
            w.writerow([text(c, r[c]) for c in columns])


def build_metadata(celebahq_root: str, celeba_anno_dir: str) -> Path:
    """Write metadata.csv with columns file_name, orig_file, split, + attrs.

    split: 0=train, 1=val, 2=test (from the original CelebA partition),
    3=extra 3k validation carved from train with seed 0 (reference
    prepare_celeba_hq.py:20-27): ``RandomState(0).choice`` over the merged
    rows' positions whose split is 0, in the mapping file's order.
    """
    root = Path(celebahq_root)
    anno = Path(celeba_anno_dir)

    cols, rows = _read_whitespace(root / "CelebA-HQ-to-CelebA-mapping.txt")
    for r in rows:
        r["file_name"] = f"{int(r['idx'])}.jpg"
    mapping = (cols + ["file_name"], rows)
    part = _read_whitespace(anno / "list_eval_partition.txt", names=["orig_file", "split"])
    cols, rows = _merge_left(mapping, part, on="orig_file")

    # carve extra validation out of train (seed 0, split id 3)
    rng = np.random.RandomState(EXTRA_VAL_SEED)
    train_idx = np.array([i for i, r in enumerate(rows) if r["split"] == 0], dtype=np.int64)
    extra = rng.choice(train_idx, size=min(N_EXTRA_VAL, len(train_idx)), replace=False)
    for i in extra:
        rows[int(i)]["split"] = EXTRA_VAL_SPLIT_ID

    attr_path = anno / "list_attr_celeba.txt"
    table = (cols, rows)
    if attr_path.exists():
        acols, arows = _read_whitespace(attr_path, header_line=1)
        for r in arows:
            r["orig_file"] = r.pop("index")
        acols = ["orig_file"] + [c for c in acols if c != "index"]
        table = _merge_left(table, (acols, arows), on="orig_file")

    out = root / "metadata.csv"
    _write_csv(out, table)
    print(f"[prep] wrote {out} ({len(table[1])} rows)")
    return out


def resize_images(celebahq_root: str, size: int = 256) -> Path:
    """1024 -> size bilinear resize into img{size}/ (reference
    resize_images.py:5-16)."""
    from PIL import Image

    root = Path(celebahq_root)
    src = root / "CelebA-HQ-img"
    dst = root / f"img{size}"
    dst.mkdir(exist_ok=True)
    files = sorted(src.glob("*.jpg")) + sorted(src.glob("*.png"))
    for i, f in enumerate(files):
        out = dst / f.name
        if out.exists():
            continue
        Image.open(f).convert("RGB").resize((size, size), Image.BILINEAR).save(out)
        if i % 1000 == 0:
            print(f"[prep] resized {i}/{len(files)}")
    print(f"[prep] wrote {dst}")
    return dst


def copy_splits(celebahq_root: str, out_dir: str, resolution: int = 256) -> None:
    """Materialize train/ and val/ dirs from metadata.csv (reference
    copy_splits.py:11-27; train={0,3}, val={1,2} matching celebahq.py:33);
    a row the partition file lacked (no split) is copied nowhere."""
    root = Path(celebahq_root)
    img_dir = root / (f"img{resolution}" if resolution != 1024 else "CelebA-HQ-img")
    out = Path(out_dir)
    (out / "train").mkdir(parents=True, exist_ok=True)
    (out / "val").mkdir(parents=True, exist_ok=True)
    with open(root / "metadata.csv") as f:
        for row in csv.DictReader(f):
            if not row["split"]:
                continue  # no partition entry: in no split
            split = "train" if int(float(row["split"])) in (0, 3) else "val"
            src = img_dir / row["file_name"]
            if src.exists():
                shutil.copy(src, out / split / row["file_name"])
    print(f"[prep] split dirs in {out}")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 1
    cmd = argv[0]
    if cmd == "build-metadata":
        build_metadata(argv[1], argv[2])
    elif cmd == "resize":
        size = int(argv[argv.index("--size") + 1]) if "--size" in argv else 256
        resize_images(argv[1], size)
    elif cmd == "copy-splits":
        copy_splits(argv[1], argv[2])
    else:
        print(__doc__)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
