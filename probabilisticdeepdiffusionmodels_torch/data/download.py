"""Dataset acquisition: download + checksum + extract for the public sets.

PyTorch-port copy of ``probabilisticdeepdiffusionmodels_tpu/data/download.py``
(the same table of files, mirrors and checksums, the same behaviour).  The
reference gets this from torchvision's ``download=True`` (and patches the
urllib user agent so the MNIST mirror accepts it, reference
src/datasets/data.py:13-22).  This module is the torchvision-free
equivalent, laying files out exactly where data/datasets.py expects them:

    python -m probabilisticdeepdiffusionmodels_torch.data.download mnist cifar10
    python -m probabilisticdeepdiffusionmodels_torch.data.download --verify-only mnist

CelebA / CelebA-HQ are NOT auto-downloadable (Google-Drive quota walls —
torchvision's own CelebA downloader fails the same way); ``celeba`` prints
the manual layout instead.

Checksums are the torchvision-published md5s (prefix ``md5:``); the
verifier also accepts ``sha256:`` entries for locally pinned files.
"""

from __future__ import annotations

import gzip
import hashlib
import shutil
import sys
import tarfile
import urllib.request
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

from .datasets import DATA_DIR

__all__ = ["MANIFEST", "download", "verify", "main"]

# the reference's UA patch analogue: some mirrors 403 the default
# urllib agent (reference data.py:13-15)
_UA = "Mozilla/5.0 (dataset fetch; probabilisticdeepdiffusionmodels_torch)"


class RemoteFile(NamedTuple):
    urls: List[str]          # mirrors, tried in order
    relpath: str             # destination under the dataset root
    checksum: Optional[str]  # "md5:..." / "sha256:..." / None
    extract: bool = False    # tar/tgz: unpack next to the file after fetch


MANIFEST: Dict[str, List[RemoteFile]] = {
    "mnist": [
        RemoteFile(
            [
                f"https://ossci-datasets.s3.amazonaws.com/mnist/{n}",
                f"http://yann.lecun.com/exdb/mnist/{n}",
            ],
            f"MNIST/raw/{n}",
            c,
        )
        for n, c in [
            ("train-images-idx3-ubyte.gz",
             "md5:f68b3c2dcbeaaa9fbdd348bbdeb94873"),
            ("train-labels-idx1-ubyte.gz",
             "md5:d53e105ee54ea40749a09fcbcd1e9432"),
            ("t10k-images-idx3-ubyte.gz",
             "md5:9fb629c4189551a2d022fa330f9573f3"),
            ("t10k-labels-idx1-ubyte.gz",
             "md5:ec29112dd5afa0611ce80d1b7f02629c"),
        ]
    ],
    "cifar10": [
        RemoteFile(
            ["https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"],
            "cifar-10-python.tar.gz",
            "md5:c58f30108f718f92721af3b95e74349a",
            extract=True,
        ),
    ],
    "svhn": [
        RemoteFile(
            ["http://ufldl.stanford.edu/housenumbers/train_32x32.mat"],
            "train_32x32.mat",
            "md5:e26dedcc434d2e4c54c9b2d4a06d8373",
        ),
        RemoteFile(
            ["http://ufldl.stanford.edu/housenumbers/test_32x32.mat"],
            "test_32x32.mat",
            "md5:eb5a983be6a315427106f1b164d9cef3",
        ),
    ],
}

_MANUAL = {
    "celeba": (
        "CelebA is served from Google Drive and cannot be fetched "
        "unattended.  Place under <root>/celeba/:\n"
        "  img_align_celeba/          (aligned jpgs)\n"
        "  list_eval_partition.txt    (name split per line)\n"
        "from https://mmlab.ie.cuhk.edu.hk/projects/CelebA.html"
    ),
    "celebahq": (
        "CelebA-HQ: place metadata.csv + img256/ (or CelebA-HQ-img/ for "
        "1024px) under the dataset root, then run data/prep_celebahq.py "
        "for resized caches and the extra val split."
    ),
}


def _checksum_of(path: Path, algo: str) -> str:
    h = hashlib.new(algo)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def verify(path: Path, checksum: Optional[str]) -> bool:
    """True iff ``path`` exists and matches ``checksum``
    ("algo:hexdigest"; None = existence check only)."""
    if not Path(path).is_file():
        return False
    if checksum is None:
        return True
    algo, _, want = checksum.partition(":")
    return _checksum_of(Path(path), algo) == want.lower()


def _fetch(urls: List[str], dest: Path) -> None:
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".part")
    last_err: Optional[Exception] = None
    for url in urls:
        try:
            req = urllib.request.Request(url, headers={"User-Agent": _UA})
            with urllib.request.urlopen(req) as r, open(tmp, "wb") as f:
                shutil.copyfileobj(r, f)
            tmp.replace(dest)
            return
        except Exception as e:  # try the next mirror
            last_err = e
            tmp.unlink(missing_ok=True)
    raise RuntimeError(f"all mirrors failed for {dest.name}: {last_err}")


def _extract(archive: Path) -> None:
    name = archive.name
    if name.endswith((".tar.gz", ".tgz", ".tar")):
        with tarfile.open(archive) as tf:
            tf.extractall(archive.parent, filter="data")
    elif name.endswith(".gz"):
        out = archive.with_suffix("")
        with gzip.open(archive, "rb") as src, open(out, "wb") as dst:
            shutil.copyfileobj(src, dst)
    else:
        raise ValueError(f"don't know how to extract {name}")


def download(name: str, root: Optional[Path] = None,
             verify_only: bool = False, log=print) -> bool:
    """Fetch-or-verify one dataset into ``root`` (default $PDDM_DATA_DIR).

    Returns True iff every file of the dataset is present and passes its
    checksum afterwards.  ``verify_only`` never touches the network — it
    reports the current state (the offline-testable mode)."""
    name = name.lower().replace("-", "")
    if name in _MANUAL:
        log(f"[download] {name}: manual acquisition required —\n"
            + _MANUAL[name])
        return False
    if name not in MANIFEST:
        raise KeyError(
            f"unknown dataset {name!r}; known: "
            f"{sorted(MANIFEST) + sorted(_MANUAL)}"
        )
    root = Path(root) if root is not None else DATA_DIR
    ok = True
    for rf in MANIFEST[name]:
        dest = root / rf.relpath
        good = verify(dest, rf.checksum)
        if good:
            log(f"[download] {dest} OK")
        elif verify_only:
            state = "checksum MISMATCH" if dest.is_file() else "missing"
            log(f"[download] {dest} {state}")
            ok = False
        else:
            log(f"[download] fetching {dest.name} ...")
            _fetch(rf.urls, dest)
            if not verify(dest, rf.checksum):
                dest.unlink(missing_ok=True)
                raise RuntimeError(
                    f"{dest.name}: checksum mismatch after download "
                    f"(expected {rf.checksum}); removed"
                )
            good = True
            log(f"[download] {dest} OK")
        if good and rf.extract:
            _extract(dest)
    return ok


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    verify_only = "--verify-only" in argv
    argv = [a for a in argv if a != "--verify-only"]
    root = None
    for a in list(argv):
        if a.startswith("--root="):
            root = Path(a.split("=", 1)[1])
            argv.remove(a)
    names = argv or sorted(MANIFEST)
    all_ok = True
    for n in names:
        all_ok &= download(n, root=root, verify_only=verify_only)
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
