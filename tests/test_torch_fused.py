"""K fused train steps (``engine.training_steps``, ``train.step.
make_fused_train_step`` and ``CapturedSteps``) and the Trainer's fused epoch,
on the CPU.

On the CPU ``training_steps`` is K eager steps, and is held bit for bit to K
``training_step`` calls: every weight, EMA weight, Adam moment and count, the
accumulation buffer, the loss history, the generator and the metrics rows.
The graph's own steps (``CapturedSteps(capture=False)``: the table-driven
Adam update, the host-count bookkeeping, no capture) are held to the eager
steps as follows: the host counts, the generator, the loss history's counts
and the first step's loss exactly; the graph's update rounds its parameter
step once more than ``torch.optim.Adam``, and Adam's first updates are about
lr * sign(g), so a round-off difference in a near-zero gradient can move a
parameter by up to 2 lr a step (test_torch_train.py): parameters and EMA
within 2 lr K, the moments within 1e-5 of the model's largest moment, the
losses within 1e-5 relative.  A checkpoint
written after the graph's steps resumes bit for bit, into either path.  The
capture itself runs on the card only (the ``gpu`` tests), where a replay is
held to the graph's steps run eagerly within 1e-6 and a replay with a zeroed
table row must fail that gate.
"""

import contextlib
import json
import pathlib

import numpy as np
import pytest
import torch

from probabilisticdeepdiffusionmodels_torch.cli import train as cli_train
from probabilisticdeepdiffusionmodels_torch.engine import DiffusionEngine
from probabilisticdeepdiffusionmodels_torch.logging.sink import RunDir
from probabilisticdeepdiffusionmodels_torch.train.checkpoint import CheckpointManager
from probabilisticdeepdiffusionmodels_torch.train.loop import Trainer
from probabilisticdeepdiffusionmodels_torch.train.step import CapturedSteps
from test_cli import TINY
from test_torch_threads import one_torch_thread  # noqa: E402,F401

RES, B, LR = 8, 4, 1e-3
CFG = dict(name="unet", in_channels=3, model_channels=16, num_res_blocks=1,
           attention_resolutions=[4], channel_mult=[1, 2], num_heads=1,
           use_scale_shift_norm=True)
CPU = ["device=cpu"]
OPTIONS = {
    "uniform": dict(),
    "importance": dict(sampling="importance"),
    "accumulate_2": dict(accumulate_grad_batches=2, grad_clip=0.5),
    "cosine_lr": dict(scheduler_name="CosineAnnealing", scheduler_kwargs=dict(T_max=4)),
}


def _engine(device="cpu", **kw):
    return DiffusionEngine(dict(CFG), {"lr": LR}, diffusion_steps=20, mode="cosine",
                           resolution=RES, ema=0.9, seed=3, device=device, **kw)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(n, B, RES, RES, 3)).astype(np.float32)


def _state(engine):
    """Every tensor of the train state by name, and its host counts."""
    s = engine.state
    out = {f"model.{k}": v for k, v in s.model.state_dict().items()}
    out.update({f"ema.{k}": v for k, v in s.ema_model.state_dict().items()})
    for i, st in enumerate(s.optimizer.adam.state.values()):
        out.update({f"adam.{i}.{k}": v for k, v in st.items()})
    for i, a in enumerate(s.optimizer.acc or []):
        out[f"acc.{i}"] = a
    for name in ("ring", "ring_pos", "count", "epoch_sum", "epoch_count"):
        out[f"history.{name}"] = getattr(s.loss_history, name)
    out["generator"] = s.generator.get_state()
    return out, (s.step, s.optimizer.updates, s.optimizer.mini_step)


def _assert_same(a, b):
    sa, ca = _state(a)
    sb, cb = _state(b)
    assert ca == cb and set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_training_steps_cpu_equal_single_steps(name):
    """Two chunks of K = 3 equal six ``training_step`` calls bit for bit (with
    accumulation over 2 the second chunk starts mid-cycle), and the metrics
    come back stacked, one row a step."""
    xs = _batches(6)
    straight, fused = _engine(**OPTIONS[name]), _engine(**OPTIONS[name])
    rows = [straight.training_step(x) for x in xs]
    m1 = fused.training_steps(xs[:3])
    m2 = fused.training_steps(torch.as_tensor(xs[3:]))
    assert set(m1) == set(rows[0]) and m1["loss"].shape == (3,)
    for key in m1:
        got = torch.cat([m1[key], m2[key]])
        assert torch.equal(got, torch.stack([r[key] for r in rows])), key
    _assert_same(straight, fused)


def test_training_steps_with_labels_and_module_norms():
    """Labels [K, B] reach a class-conditional model, and nested metrics (the
    per-module gradient norms) stack too."""
    kw = dict(watch=True, class_dropout_prob=0.3)
    cfg = dict(CFG, num_classes=3, cfg_null_class=True)
    straight, fused = (DiffusionEngine(cfg, {"lr": LR}, diffusion_steps=20, mode="cosine",
                                       resolution=RES, device="cpu", seed=1, **kw)
                       for _ in range(2))
    xs, ys = _batches(2, 1), np.array([[0, 1, 2, 0], [2, 2, 1, 0]])
    rows = [straight.training_step(x, y) for x, y in zip(xs, ys)]
    m = fused.training_steps(xs, ys)
    per_module = m["grad_norm_per_module"]
    assert set(per_module) == set(rows[0]["grad_norm_per_module"])
    for k, v in per_module.items():
        assert torch.equal(v, torch.stack([r["grad_norm_per_module"][k] for r in rows]))
    assert torch.equal(straight.state.generator.get_state(), fused.state.generator.get_state())


@pytest.mark.parametrize("name", ["uniform", "accumulate_2", "cosine_lr"])
def test_graph_steps_match_eager_steps(name):
    """Two chunks of K = 3 of the graph's steps, run eagerly, against six
    eager steps (tolerances in the module docstring); the Adam counts move
    on the host after each chunk."""
    xs = torch.as_tensor(_batches(6, 2))
    eager, graph = _engine(**OPTIONS[name]), _engine(**OPTIONS[name])
    rows = [eager.training_step(x) for x in xs]
    chunk = CapturedSteps(graph._train_step, graph.state, xs[:3], capture=False)
    metrics = [chunk(xs[:3]), chunk(xs[3:])]
    assert float(metrics[0]["loss"][0]) == float(rows[0]["loss"])
    got, counts = _state(graph)
    want, want_counts = _state(eager)
    assert counts == want_counts
    assert torch.equal(got["generator"], want["generator"])
    for k in ("count", "ring_pos", "epoch_count"):
        assert torch.equal(got[f"history.{k}"], want[f"history.{k}"]), k
    for k, w in want.items():
        if k.startswith(("model.", "ema.")):
            assert float((got[k] - w).abs().max()) <= 2 * LR * 6, k
        elif k.endswith("step"):
            assert torch.equal(got[k], w), k
    for kind in ("exp_avg", "exp_avg_sq"):
        names = [k for k in want if k.endswith("." + kind)]
        largest = max(float(want[k].abs().max()) for k in names)
        for k in names:
            assert float((got[k] - want[k]).abs().max()) <= 1e-5 * largest, k
    np.testing.assert_allclose(torch.cat([m["loss"] for m in metrics]).numpy(),
                               torch.stack([r["loss"] for r in rows]).numpy(), rtol=1e-5)


def test_graph_table_rows():
    """The table holds, for each update the next K steps make, -lr(n) /
    (1 - b1^(n+1)) and sqrt(1 - b2^(n+1)) from the host's count; with
    accumulation over 2 from mid-cycle, the updates of steps 1 and 3."""
    engine = _engine(accumulate_grad_batches=2, scheduler_name="StepLR",
                     scheduler_kwargs=dict(step_size=1, gamma=0.5))
    opt = engine.state.optimizer
    opt.updates, opt.mini_step = 2, 1
    rows = opt.update_scalars(4).numpy()
    want = [[-(LR * 0.5 ** n) / (1 - 0.9 ** (n + 1)), (1 - 0.999 ** (n + 1)) ** 0.5]
            for n in (2, 3)]
    np.testing.assert_array_equal(rows[:2], np.asarray(want, np.float32))
    np.testing.assert_array_equal(rows[2:], 0)


@pytest.mark.parametrize("then", ["graph", "eager"])
def test_checkpoint_after_graph_steps_resumes_bit_for_bit(then, tmp_path):
    """2 of the graph's steps, a checkpoint, a fresh engine restored from it
    and 2 more steps (the graph's or eager ones) equal the 2 + 2 steps of
    one engine bit for bit."""
    xs = torch.as_tensor(_batches(4, 4))
    kw = OPTIONS["accumulate_2"]

    def first_two(engine):
        chunk = CapturedSteps(engine._train_step, engine.state, xs[:2], capture=False)
        chunk(xs[:2])
        return chunk

    def last_two(engine, chunk):
        if then == "graph":
            chunk(xs[2:])
        else:
            for x in xs[2:]:
                engine.training_step(x)

    straight = _engine(**kw)
    last_two(straight, first_two(straight))
    first = _engine(**kw)
    first_two(first)
    CheckpointManager(tmp_path).save(first.state, first.state.step)
    resumed = _engine(**kw)
    CheckpointManager(tmp_path).restore(resumed.state)
    last_two(resumed, CapturedSteps(resumed._train_step, resumed.state, xs[2:], capture=False))
    _assert_same(straight, resumed)


def test_ct_annealing_keys_its_levels():
    """A CT step with grid annealing names the level each of the K steps
    reads from the host count: a graph is captured per run of levels."""
    engine = DiffusionEngine(dict(CFG), {"lr": LR}, diffusion_steps=20, mode="cosine",
                             resolution=RES, device="cpu", prediction_type="consistency",
                             consistency_config=dict(grid_size=9, grid_init=3, anneal_steps=4))
    key = engine._train_step.host_key
    engine.state.step = 1
    assert key(engine.state, 4) == (0, 1, 1, 2)  # levels of 3, 6, 9 points, 2 steps each
    engine.state.step = 30
    assert key(engine.state, 2) == (2, 2)


def test_ct_graphs_of_a_passed_level_are_dropped(monkeypatch):
    """Chunks of K = 3 across the CT grid levels (2 steps each): a graph is
    made per run of levels, and once a chunk starts at a higher level the
    graphs that start lower are dropped; the cache keeps one graph."""
    from probabilisticdeepdiffusionmodels_torch.train import step as step_mod

    made = []
    monkeypatch.setattr(step_mod, "CapturedSteps",
                        lambda step, state, xs, ys, **kw: made.append(xs.shape) or object())
    engine = DiffusionEngine(dict(CFG), {"lr": LR}, diffusion_steps=20, mode="cosine",
                             resolution=RES, device="cpu", prediction_type="consistency",
                             consistency_config=dict(grid_size=9, grid_init=3, anneal_steps=4))
    fused = step_mod.make_fused_train_step(engine._train_step)
    xs = torch.zeros((3, B, RES, RES, 3))
    kept = []
    for start in (0, 3, 6, 9, 12):
        engine.state.step = start
        chunk = fused.graph_for(engine.state, xs)
        assert fused.graph_for(engine.state, xs) is chunk
        kept.append(sorted(key[-1] for key in fused.graphs))
    assert kept == [[(0, 0, 1)], [(1, 2, 2)], [(2, 2, 2)], [(2, 2, 2)], [(2, 2, 2)]]
    assert len(made) == 3


# ------------------------------------------------------------- the Trainer


class _Spy:
    """An engine's ``training_steps`` and ``training_step`` calls, recorded."""

    def __init__(self, engine):
        self.calls = []
        for name in ("training_steps", "training_step"):
            real = getattr(engine, name)

            def wrapped(x, y=None, _real=real, _name=name):
                self.calls.append((_name, tuple(np.shape(x))))
                return _real(x, y)
            setattr(engine, name, wrapped)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_trainer_fused_epoch(prefetch, tmp_path):
    """Trainer(fused_steps=3) over 2 epochs of 11 batches and a ragged last
    one: chunks of 3, the short last chunk and the ragged batch one step
    each, with or without prefetch; the run equals the per-step Trainer bit
    for bit, and logs and saves where the step count crosses its cadence."""
    ds_x = np.random.default_rng(5).uniform(-1, 1, (44, RES, RES, 3)).astype(np.float32)

    class Loader:
        def __iter__(self):
            for lo in range(0, 44, B):
                yield ds_x[lo:lo + B], np.zeros(len(ds_x[lo:lo + B]), np.int64)
            yield ds_x[:2], np.zeros(2, np.int64)  # ragged

    def fit(fused):
        engine = _engine()
        spy = _Spy(engine)
        run = RunDir(str(tmp_path), f"fused{fused}_p{prefetch}")
        trainer = Trainer(engine, run, max_epochs=2, check_val_every_n_epoch=5,
                          log_every_steps=4, save_every_steps=5, prefetch=prefetch,
                          fused_steps=fused)
        result = trainer.fit(Loader(), [])
        rows = [json.loads(line) for line in (run.path / "metrics.jsonl").read_text().splitlines()]
        return engine, spy.calls, result, rows, run

    plain, plain_calls, plain_result, plain_rows, _ = fit(0)
    fused, calls, result, rows, run = fit(3)
    assert result == plain_result and result["steps"] == 24
    chunk = ("training_steps", (3, B, RES, RES, 3))
    single = ("training_step", (B, RES, RES, 3))
    epoch = [chunk] * 3 + [single, single, ("training_step", (2, RES, RES, 3))]
    assert calls == epoch * 2 and len(plain_calls) == 24
    _assert_same(plain, fused)
    logged = [r["step"] for r in rows if "loss" in r]
    assert logged == [6, 9, 12, 18, 21, 24]  # crossings of 4, 8, ... at chunk ends
    assert [r["step"] for r in plain_rows if "loss" in r] == [4, 8, 12, 16, 20, 24]
    saved = sorted(int(p.name) for p in (run.path / "checkpoints").iterdir())
    assert saved == [6, 10, 15, 21]


def test_train_cli_fused_device_resident(tmp_path):
    """``cli.train trainer.fused_steps=2 data.device_resident=true`` on the
    CPU is the plain run: the same final metrics and checkpoints."""
    base = TINY + CPU + [f"out_dir={tmp_path}", "trainer.max_epochs=1",
                         "trainer.check_val_every_n_epoch=1"]
    plain = cli_train.main(base + ["run_name=plain"])
    fused = cli_train.main(base + ["run_name=fused", "trainer.fused_steps=2",
                                   "data.device_resident=true"])
    assert {k: v for k, v in fused.items() if k != "run_dir"} == {
        k: v for k, v in plain.items() if k != "run_dir"}
    assert fused["steps"] == 2
    got = torch.load(pathlib.Path(fused["run_dir"]) / "checkpoints" / "2" / "state.pt",
                     weights_only=True)
    want = torch.load(pathlib.Path(plain["run_dir"]) / "checkpoints" / "2" / "state.pt",
                      weights_only=True)
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k


# ------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _worst(a, b, prefixes):
    """The largest absolute difference of the state tensors of engines a and
    b whose names start with one of ``prefixes``."""
    sa, sb = _state(a)[0], _state(b)[0]
    return max(float((sa[k].double() - sb[k].double()).abs().max())
               for k in sa if k.startswith(prefixes))


@contextlib.contextmanager
def _same_bits_on_card():
    """TF32 off and cuDNN's deterministic algorithms on, restored after:
    cuDNN's default weight gradients (the plain versions' recompute) may sum
    in any order, so two runs of the same steps differ in their last bits."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


@pytest.mark.gpu
def test_card_graph_matches_eager_and_captures_once():
    """On the card, with cuDNN deterministic: two chunks of K = 2 through
    ``training_steps`` (the first the warm-up and the capture, the second a
    replay) against the graph's steps run eagerly
    (``CapturedSteps(capture=False)``: the same arithmetic), every tensor of
    the state and every metrics row within 1e-6, and against four eager
    steps: counts and the generator equal, parameters and EMA within LR /
    10, the moments within 1e-5 of the largest, losses within 1e-5
    relative; one capture; the GroupNorm counters of the capture stream
    zero after a replay.  A third replay with its table's second row zeroed
    (that update's parameter step skipped) leaves the parameters more than
    LR / 10 from the graph's steps run eagerly."""
    _card()
    with _same_bits_on_card():
        _graph_against_eager()


def _graph_against_eager():
    from probabilisticdeepdiffusionmodels_torch.ops import groupnorm

    xs = torch.as_tensor(_batches(4, 6), device="cuda")
    eager, body, graph = _engine("cuda"), _engine("cuda"), _engine("cuda")
    rows = [eager.training_step(x) for x in xs]
    chunk = CapturedSteps(body._train_step, body.state, xs[:2], capture=False)
    body_rows = [chunk(xs[:2]), chunk(xs[2:])]
    metrics = [graph.training_steps(xs[:2]), graph.training_steps(xs[2:])]
    chunks = list(graph._fused_step.graphs.values())
    assert len(chunks) == 1 and chunks[0].captures == 1
    torch.cuda.synchronize()
    for key, buf in groupnorm._counters.items():
        assert not buf.any(), key
    got, counts = _state(graph)
    same, same_counts = _state(body)
    assert counts == same_counts and torch.equal(got["generator"], same["generator"])
    assert _worst(graph, body, ("model.", "ema.", "adam.", "history.")) <= 1e-6
    for m, b in zip(metrics, body_rows):
        for key in m:
            torch.testing.assert_close(m[key], b[key], rtol=0, atol=1e-6, msg=key)
    want, want_counts = _state(eager)
    assert counts == want_counts and torch.equal(got["generator"], want["generator"])
    for k in ("count", "ring_pos", "epoch_count"):
        assert torch.equal(got[f"history.{k}"], want[f"history.{k}"]), k
    assert _worst(graph, eager, ("model.", "ema.")) <= LR / 10
    for k, w in want.items():
        if k.endswith("step"):
            assert torch.equal(got[k], w), k
    for kind in ("exp_avg", "exp_avg_sq"):
        names = [k for k in want if k.endswith("." + kind)]
        largest = max(float(want[k].abs().max()) for k in names)
        for k in names:
            assert float((got[k] - want[k]).abs().max()) <= 1e-5 * largest, k
    np.testing.assert_allclose(torch.cat([m["loss"] for m in metrics]).cpu().numpy(),
                               torch.stack([r["loss"] for r in rows]).cpu().numpy(), rtol=1e-5)

    opt = graph.state.optimizer
    real = opt.update_scalars
    opt.update_scalars = lambda n: real(n).index_fill_(0, torch.tensor([1]), 0.0)
    graph.training_steps(xs[:2])
    chunk(xs[:2])
    assert chunks[0].captures == 1
    assert _worst(graph, body, ("model.",)) > LR / 10
