"""FID scoring entry point.

PyTorch counterpart of ``probabilisticdeepdiffusionmodels_tpu/cli/fid_score.py``,
with its positional arguments:

    python -m probabilisticdeepdiffusionmodels_torch.cli.fid_score \\
        <run_dir> <clip: true|false> [n_samples] [num_sample_steps] [devices] [pr] [kid] [is]

samples ``n_samples`` (default 10000) images from the run's best checkpoint
and scores them against its val split.  An empty argument keeps the
default.  ``num_sample_steps`` is an int (respacing) or a spec
("karras50", "10,20,20").  ``pr`` (default true) adds improved precision
and recall, ``kid`` (default false) the Kernel Inception Distance, ``is``
(default false) the Inception Score, each on the first 4096 feature rows
of a side.  ``devices`` other than empty or 1 (a mesh) raises: ROADMAP.md
Queue 1 item 18.  An argument ``device=cpu`` anywhere runs on the CPU (the
default is cuda).

The weights' stamp is printed on every path: ``ported:<md5>`` means
pytorch-fid's checkpoint (``PDDM_INCEPTION_WEIGHTS``) and a comparable FID,
``random`` a pipeline run whose numbers compare with nothing published.
The last line is the pipeline's seconds and sampled img/s.
"""

from __future__ import annotations

import sys
import time

from ..evals.fid import compute_fid_from_engine
from ..evals.inception import load_params
from .sample import load_engine_from_run
from .train import build_loaders

__all__ = ["main"]


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    device = None
    for a in [a for a in argv if a.startswith("device=")]:
        argv.remove(a)
        device = a.partition("=")[2] or None
    if not argv:
        print(__doc__)
        return 1
    run_dir = argv[0]
    clip = (argv[1].lower() == "true") if len(argv) > 1 else True
    n_samples = int(argv[2]) if len(argv) > 2 and argv[2] else 10000
    num_steps = None
    if len(argv) > 3 and argv[3]:
        num_steps = int(argv[3]) if argv[3].isdigit() else argv[3]
    devices = (argv[4] or None) if len(argv) > 4 else None
    with_pr = (argv[5].lower() == "true") if len(argv) > 5 else True
    with_kid = (argv[6].lower() == "true") if len(argv) > 6 else False
    with_is = (argv[7].lower() == "true") if len(argv) > 7 else False

    engine, run_cfg = load_engine_from_run(run_dir, clip_while_generating=clip,
                                           devices=devices, device=device)
    _, val_loader = build_loaders(run_cfg)
    normalize = (run_cfg["data"].get("transformation_kwargs") or {}).get("normalize")

    # the weights load here, so the stamp exists on every path, the bare
    # FID's included
    inception_params, provenance = load_params(with_provenance=True, device=engine.device)
    t0 = time.perf_counter()
    m = compute_fid_from_engine(
        engine, val_loader, n_samples=n_samples, normalize=normalize,
        num_sample_steps=num_steps, with_precision_recall=with_pr,
        with_kid=with_kid, with_inception_score=with_is,
        inception_params=inception_params, inception_provenance=provenance,
    )
    wall = time.perf_counter() - t0
    extras = with_pr or with_kid or with_is
    fid = m["fid"] if extras else m
    print(f"FID: {fid} (run={run_dir} clip={clip} n={n_samples})")
    print(f"inception_weights: {provenance}")
    if with_pr:
        print(f"precision: {m['precision']:.4f}  recall: {m['recall']:.4f} "
              "(improved P&R, arXiv:1904.06991)")
    if with_kid:
        print(f"KID: {m['kid_mean']:.6f} +/- {m['kid_std']:.6f} "
              f"(subsets {m['kid_n_subsets']}x{m['kid_subset_size']}, arXiv:1801.01401)")
    if with_is:
        print(f"IS: {m['is_mean']:.4f} +/- {m['is_std']:.4f} "
              f"({m['is_splits']} splits, arXiv:1606.03498)")
    print(f"FID pipeline: {wall:.1f} s wall, {n_samples / wall:.2f} sampled-img/s end-to-end")
    return 0


if __name__ == "__main__":
    sys.exit(main())
