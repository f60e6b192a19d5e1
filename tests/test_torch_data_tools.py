"""The port's data tools against the JAX package's: the native transform
(``data/native``), the offline acquisition (``data/download``) and the
CelebA-HQ preparation (``data/prep_celebahq``).

Tolerances: the native transform bit for bit against JAX's numpy executor
(``Transform(...)(images, rng, use_native=False)``; JAX's own native
executor is not called, since it would rebuild the library the repo tracks
beside its source); ``metadata.csv`` the same rows and values, read back
with ``csv``; the resized images the same pixels.  Nothing is fetched: the
download runs with ``_fetch`` patched.
"""

import csv
import gzip
import hashlib
import subprocess
import tarfile

import numpy as np
import pytest
from PIL import Image

from probabilisticdeepdiffusionmodels_torch.data import download as dl
from probabilisticdeepdiffusionmodels_torch.data import native
from probabilisticdeepdiffusionmodels_torch.data import prep_celebahq as prep
from probabilisticdeepdiffusionmodels_torch.data.datasets import DataLoader, load_cifar10
from probabilisticdeepdiffusionmodels_torch.data.transforms import Transform
from probabilisticdeepdiffusionmodels_tpu.data import prep_celebahq as jax_prep
from probabilisticdeepdiffusionmodels_tpu.data.transforms import Transform as JaxTransform
from test_torch_threads import one_torch_thread  # noqa: E402,F401

_KWARGS = [
    dict(normalize="oneone", flip=True),
    dict(normalize="mnist", crop=True, crop_size=28, crop_padding=4),
    dict(normalize=None, flip=True, crop=True, crop_size=24, crop_padding=0),
    dict(normalize="cifar", flip=True, crop=True, crop_size=32, crop_padding=4),
    dict(normalize=((0.1, 0.2, 0.3), (0.9, 0.5, 0.7)), flip=True),
    dict(normalize="cifar", train=False, crop=True, crop_size=32, crop_padding=4),
]


@pytest.mark.parametrize("kwargs", _KWARGS, ids=["oneone_flip", "mnist_crop", "none_crop0",
                                                 "cifar_flip_crop", "explicit", "eval_crop"])
def test_native_transform_bit_for_bit(kwargs):
    """The port's native executor against JAX's numpy executor on seeded
    uint8 batches: the same draws, the same bits."""
    kwargs = dict(kwargs)
    train = kwargs.pop("train", True)
    ch = 1 if kwargs.get("normalize") == "mnist" else 3
    side = 28 if ch == 1 else 32
    raw = np.random.default_rng(0).integers(0, 256, size=(16, side, side, ch), dtype=np.uint8)
    port = Transform(train=train, **kwargs)
    got = port(raw, np.random.default_rng(42))
    assert port.executor == "native"
    want = JaxTransform(train=train, **kwargs)(raw, np.random.default_rng(42), use_native=False)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_loader_runs_native_and_float_images_numpy():
    """The loader's batches come from the native executor; float images
    take numpy, as in JAX."""
    from probabilisticdeepdiffusionmodels_torch.data import ArrayDataset

    ds = ArrayDataset(np.random.default_rng(1).integers(0, 256, (8, 8, 8, 3), dtype=np.uint8))
    loader = DataLoader(ds, batch_size=4, transformation_kwargs=dict(flip=True))
    next(iter(loader))
    assert loader.transform.executor == "native"
    tf = Transform(flip=True)
    tf(np.zeros((2, 4, 4, 3), np.float32), np.random.default_rng(0))
    assert tf.executor == "numpy"


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A compiler that fails, or is missing, raises with its output; nothing
    falls back to numpy."""
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "_lib", None)

    def failing(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 1, stdout="", stderr="no compiler here")

    monkeypatch.setattr(native.subprocess, "run", failing)
    with pytest.raises(RuntimeError, match="no compiler here"):
        native.get_lib()

    def missing(cmd, **kw):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native.subprocess, "run", missing)
    with pytest.raises(RuntimeError, match="failed"):
        Transform(flip=True)(np.zeros((1, 4, 4, 3), np.uint8), np.random.default_rng(0))
    assert not list((tmp_path / "native").glob("*.so"))


def test_native_builds_outside_the_package():
    path = native.build()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert not list(native._SRC.parent.glob("*.so"))


# ------------------------------------------------------------- download


def _md5(b: bytes) -> str:
    return hashlib.md5(b).hexdigest()


def test_download_table_is_jax_table():
    from probabilisticdeepdiffusionmodels_tpu.data import download as jax_dl

    assert {k: [tuple(f) for f in v] for k, v in dl.MANIFEST.items()} == \
        {k: [tuple(f) for f in v] for k, v in jax_dl.MANIFEST.items()}


def test_verify_checksums(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(b"hello")
    assert dl.verify(p, "md5:" + _md5(b"hello"))
    assert dl.verify(p, "sha256:" + hashlib.sha256(b"hello").hexdigest())
    assert not dl.verify(p, "md5:" + _md5(b"other"))
    assert not dl.verify(tmp_path / "absent", None)
    assert dl.verify(p, None)


def test_verify_only_and_manual_sets(tmp_path, capsys):
    assert not dl.download("mnist", root=tmp_path, verify_only=True)
    assert "missing" in capsys.readouterr().out
    assert not dl.download("celeba", root=tmp_path)
    assert "manual" in capsys.readouterr().out
    with pytest.raises(KeyError):
        dl.download("nope", root=tmp_path)
    assert dl.main(["--verify-only", f"--root={tmp_path}", "mnist"]) == 1


def test_fetch_checksums_extracts_and_skips_present(tmp_path, monkeypatch):
    """A patched fetch lands a CIFAR tarball that extracts into the loader's
    layout; a second call verifies in place and fetches nothing; a corrupt
    fetch is removed and raises; a .gz extracts beside itself."""
    import pickle

    rng = np.random.default_rng(0)
    batches = tmp_path / "src" / "cifar-10-batches-py"
    batches.mkdir(parents=True)
    for n in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(batches / n, "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
                         b"labels": [0, 1, 2, 3]}, f)
    tar = tmp_path / "src" / "cifar-10-python.tar.gz"
    with tarfile.open(tar, "w:gz") as tf:
        tf.add(batches, arcname="cifar-10-batches-py")
    blob = tar.read_bytes()
    fetched = []

    def fake_fetch(urls, dest):
        fetched.append(dest.name)
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_bytes(blob)

    monkeypatch.setattr(dl, "_fetch", fake_fetch)
    monkeypatch.setitem(dl.MANIFEST, "cifar10", [dl.MANIFEST["cifar10"][0]._replace(
        checksum="md5:" + _md5(blob))])
    root = tmp_path / "data"
    assert dl.download("cifar10", root=root)
    assert load_cifar10(root, train=True).images.shape == (20, 32, 32, 3)
    assert dl.download("cifar10", root=root) and fetched == ["cifar-10-python.tar.gz"]

    monkeypatch.setitem(dl.MANIFEST, "cifar10", [dl.MANIFEST["cifar10"][0]._replace(
        checksum="md5:" + _md5(b"something else"))])
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        dl.download("cifar10", root=tmp_path / "other")
    assert not (tmp_path / "other" / "cifar-10-python.tar.gz").exists()

    gz = tmp_path / "g" / "t.gz"
    gz.parent.mkdir()
    gz.write_bytes(gzip.compress(b"payload"))
    dl._extract(gz)
    assert (tmp_path / "g" / "t").read_bytes() == b"payload"


# ------------------------------------------------------------- CelebA-HQ prep


def _celebahq_tree(root, missing):
    hq, anno = root / "hq", root / "anno"
    (hq / "CelebA-HQ-img").mkdir(parents=True)
    anno.mkdir()
    n = 30
    with open(hq / "CelebA-HQ-to-CelebA-mapping.txt", "w") as f:
        f.write("idx orig_idx orig_file\n")
        for i in range(n):
            f.write(f"{i} {i * 7} {i * 3:06d}.jpg\n")
    with open(anno / "list_eval_partition.txt", "w") as f:
        for i in range(n):
            if not (missing and i == 5):
                f.write(f"{i * 3:06d}.jpg {0 if i < 20 else (1 if i < 25 else 2)}\n")
    with open(anno / "list_attr_celeba.txt", "w") as f:
        f.write(f"{n}\nSmiling Male Young\n")
        for i in range(n):
            if not (missing and i == 9):
                vals = np.random.default_rng(i).choice([-1, 1], 3)
                f.write(f"{i * 3:06d}.jpg " + " ".join(str(v) for v in vals) + "\n")
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)).save(
            hq / "CelebA-HQ-img" / f"{i}.jpg")
    return hq, anno


@pytest.mark.parametrize("missing", [False, True], ids=["complete", "missing_rows"])
def test_prep_celebahq_matches_jax(tmp_path, monkeypatch, missing):
    """metadata.csv: the same header, rows and values as JAX's (pandas) one,
    the extra-validation carve included, and a partition or attribute row
    missing; the resized images: the same pixels; the split directories."""
    monkeypatch.setattr(prep, "N_EXTRA_VAL", 5)
    monkeypatch.setattr(jax_prep, "N_EXTRA_VAL", 5)
    ours, theirs = (_celebahq_tree(tmp_path / side, missing) for side in ("port", "jax"))
    prep.build_metadata(str(ours[0]), str(ours[1]))
    jax_prep.build_metadata(str(theirs[0]), str(theirs[1]))
    rows = [list(csv.reader(open(hq / "metadata.csv"))) for hq in (ours[0], theirs[0])]
    assert rows[0] == rows[1]
    assert rows[0][0][:5] == ["idx", "orig_idx", "orig_file", "file_name", "split"]
    splits = [r[4] for r in rows[0][1:]]
    assert sum(s in ("3", "3.0") for s in splits) == 5

    prep.resize_images(str(ours[0]), size=16)
    jax_prep.resize_images(str(theirs[0]), size=16)
    for i in range(4):
        a = np.asarray(Image.open(ours[0] / "img16" / f"{i}.jpg"))
        b = np.asarray(Image.open(theirs[0] / "img16" / f"{i}.jpg"))
        assert a.shape == (16, 16, 3)
        np.testing.assert_array_equal(a, b)
    prep.copy_splits(str(ours[0]), str(tmp_path / "splits"), resolution=16)
    copied = {p.parent.name for p in (tmp_path / "splits").rglob("*.jpg")}
    assert copied <= {"train", "val"} and len(list((tmp_path / "splits").rglob("*.jpg"))) == 4
