"""The PyTorch port's Trainer (train/trainer.py) on the CPU against the JAX
Trainer, both started from the same JAX parameters, over 2 epochs of a tiny
on-disk Charades-style fixture whose splits are not a multiple of the batch
(the last batch of each is padded): the same stdout lines in the same order,
the same stats keys and lengths, the first train loss within 1e-5 and the
later train and eval losses within 2e-4 (the tolerances of
tests/_torch_train_common.py::assert_steps_match_jax). Then the port's own
contracts: a resumed run equals an uninterrupted one bit for bit, the
checkpoint round-trips Adam's state exactly and survives a failed save,
save_best, debug_nans, and the refusal of what the port does not have yet."""

import contextlib
import dataclasses
import io
import json
import os
import re
import threading
import time

import jax
import numpy as np
import pytest
import torch

import _torch_seq_workers
from _torch_train_common import TINY_CFG, load_jax_native
from video_moment_localization_tpu.config import load_config as j_load_config
from video_moment_localization_tpu.data.pipeline import BatchLoader as JBatchLoader
from video_moment_localization_tpu.models import init_smin_params
from video_moment_localization_tpu.train.trainer import Trainer as JTrainer
from video_moment_localization_tpu.train.trainer import build_datasets as j_build_datasets
from video_moment_localization_tpu_torch.config import load_config
from video_moment_localization_tpu_torch.data.pipeline import BatchLoader
from video_moment_localization_tpu_torch.data.synthetic import write_charades_style_dir
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.parallel import mesh
from video_moment_localization_tpu_torch.train.trainer import Trainer, build_datasets, check_world
from video_moment_localization_tpu_torch.utils import checkpoint as ckpt_mod
from video_moment_localization_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    write_charades_style_dir(str(root / "data"), queries_per_video=2,
                             videos_per_split={"train": 5, "test": 3})
    return root


def write_cfg(root, name, resume=False, **extra):
    """A config file ``name``.yml (its stem is the experiment name) under
    ``root`` with its checkpoints in ``root/name``."""
    path = root / f"{name}.yml"
    text = TINY_CFG.format(ckpt=str(root / name), data=str(root / "data"), resume=resume)
    path.write_text(text + "".join(f"{k}: {v}\n" for k, v in extra.items()))
    return str(path)


def loaders(build, loader_cls, cfg):
    train, evald = build(cfg)
    return (loader_cls(train, cfg.batch_size, shuffle=True, num_workers=cfg.num_workers,
                       seed=cfg.seed),
            loader_cls(evald, cfg.batch_size, shuffle=False, num_workers=cfg.num_workers,
                       seed=cfg.seed))


def line_labels(out):
    """Each stdout line without its numbers."""
    return [re.sub(r"-?\d+\.\d+(e-?\d+)?|\b\d+\b", "#", line) for line in out.splitlines()]


def run_port(cfg_path, state_dict=None, **kw):
    cfg = load_config(cfg_path)
    trainer = Trainer(cfg, device="cpu", state_dict=state_dict, **kw)
    trainer.fit(*loaders(build_datasets, BatchLoader, cfg))
    with open(trainer.stats_path) as fh:
        return trainer, json.load(fh)


@pytest.fixture(scope="module")
def jax_runs(data_dir):
    """The JAX Trainer's stdout and stats at eval_every 1 and 2, and the
    initial parameters it started from."""
    runs = {}
    params = None
    for every in (1, 2):
        cfg = j_load_config(write_cfg(data_dir, f"jax_every{every}", eval_every=every))
        trainer = JTrainer(cfg)
        if params is None:
            params = jax.tree.map(np.asarray, init_smin_params(jax.random.PRNGKey(cfg.seed),
                                                                cfg.model))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            trainer.fit(*loaders(j_build_datasets, JBatchLoader, cfg))
        with open(trainer.stats_path) as fh:
            runs[every] = (buf.getvalue(), json.load(fh))
    return params, runs


@pytest.mark.parametrize("every", [1, 2])
def test_trainer_matches_jax_trainer(every, data_dir, jax_runs, capsys):
    params, runs = jax_runs
    want_out, want = runs[every]
    capsys.readouterr()
    _, got = run_port(write_cfg(data_dir, f"port_every{every}", eval_every=every),
                      state_dict=state_dict_from_jax_params(params))
    got_out = capsys.readouterr().out
    assert line_labels(got_out) == line_labels(want_out)
    assert got.keys() == want.keys()
    assert {k: len(v) for k, v in got.items()} == {k: len(v) for k, v in want.items()}
    assert got["epoch"] == want["epoch"] == [1, 2]
    if every == 2:
        assert got["eval_epoch"] == want["eval_epoch"] == [2]
    np.testing.assert_allclose(got["train_loss"][0], want["train_loss"][0], rtol=1e-5)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=2e-4)
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=2e-4)
    assert got["train_R@1, IoU=0.1"][0] == want["train_R@1, IoU=0.1"][0]


def test_resumed_run_equals_uninterrupted_bit_for_bit(data_dir, capsys):
    _, whole = run_port(write_cfg(data_dir, "whole"))
    cut = write_cfg(data_dir, "cut")
    cfg = load_config(cut, num_epochs_override=1)
    Trainer(cfg, device="cpu").fit(*loaders(build_datasets, BatchLoader, cfg))
    capsys.readouterr()
    trainer, resumed = run_port(write_cfg(data_dir, "cut", resume=True))
    out = capsys.readouterr().out
    assert "Training Epoch - 2" in out and "Training Epoch - 1" not in out
    assert resumed == whole
    assert load_checkpoint(trainer.model_path)["epoch"] == 2


def test_checkpoint_round_trips_adam_state(data_dir, tmp_path):
    cfg = load_config(write_cfg(data_dir, "roundtrip"))
    trainer = Trainer(cfg, device="cpu")
    train_loader, _ = loaders(build_datasets, BatchLoader, cfg)
    trainer._run_epoch(train_loader, 1, True)
    path = str(tmp_path / "x_model.ckpt")
    save_checkpoint(path, 1, trainer.model, trainer.optimizer)
    fresh = Trainer(cfg, device="cpu")
    ckpt = load_checkpoint(path)
    fresh.model.load_state_dict(ckpt["model"])
    fresh.optimizer.load_state_dict(ckpt["optimizer"])
    want, got = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert want["param_groups"] == got["param_groups"]
    assert want["state"].keys() == got["state"].keys()
    for k, state in want["state"].items():
        for name, v in state.items():
            assert torch.equal(v, got["state"][k][name]), (k, name)
    for (n, p), q in zip(trainer.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(p, q), n
    assert os.listdir(tmp_path) == ["x_model.ckpt"]


def test_failed_save_keeps_the_previous_checkpoint(data_dir, tmp_path, monkeypatch):
    cfg = load_config(write_cfg(data_dir, "failsave"))
    trainer = Trainer(cfg, device="cpu")
    path = str(tmp_path / "y_model.ckpt")
    save_checkpoint(path, 1, trainer.model, trainer.optimizer)

    def broken_save(obj, fh):
        fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(path, 2, trainer.model, trainer.optimizer)
    monkeypatch.undo()
    assert load_checkpoint(path)["epoch"] == 1
    assert os.listdir(tmp_path) == ["y_model.ckpt"]


def test_save_best_and_load_best(data_dir, capsys):
    trainer, stats = run_port(write_cfg(data_dir, "best", save_best='"R@5, IoU=0.1"'))
    out = capsys.readouterr().out
    best_lines = [line for line in out.splitlines() if line.startswith("new best")]
    assert best_lines and best_lines[0].startswith("new best eval_R@5, IoU=0.1 - ")
    best_epoch = int(re.search(r"\(epoch (\d+)\)", best_lines[-1]).group(1))
    best = load_checkpoint(trainer.best_model_path)
    assert best["epoch"] == best_epoch
    assert max(stats["eval_R@5, IoU=0.1"]) == stats["eval_R@5, IoU=0.1"][best_epoch - 1]
    trainer.load_for_test(use_best=True)
    for name, p in trainer.model.state_dict().items():
        assert torch.equal(p, best["model"][name]), name
    with pytest.raises(ValueError, match="save_best metric"):
        Trainer(dataclasses.replace(load_config(write_cfg(data_dir, "best")),
                                    save_best="R@2, IoU=0.9"), device="cpu")


def test_debug_nans_names_epoch_and_step(data_dir):
    cfg = load_config(write_cfg(data_dir, "nans"))
    trainer = Trainer(cfg, device="cpu", debug_nans=True)
    with torch.no_grad():
        trainer.model.smis[0].content_unit.attn_layer.W_q.weight.fill_(float("nan"))
    train_loader, _ = loaders(build_datasets, BatchLoader, cfg)
    with pytest.raises(FloatingPointError, match="at epoch 3, train step 1"):
        trainer._run_epoch(train_loader, 3, True)


def test_step_error_stops_the_loader_thread(data_dir):
    """A step that raises mid-epoch stops the loader's producer thread while
    the exception is still held (the traceback keeps the epoch's frame)."""
    cfg = load_config(write_cfg(data_dir, "raises"))
    trainer = Trainer(cfg, device="cpu")
    train_loader = BatchLoader(build_datasets(cfg)[0], 1, num_workers=2, prefetch=1)
    calls = []

    def broken_step(batch):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("step failed")
        return trainer.train_step(batch)

    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="step failed") as excinfo:
        trainer._run_epoch(train_loader, 1, True, step_fn=broken_step)
    deadline = time.time() + 10
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before and excinfo.traceback


@pytest.mark.parametrize("change,item", [
    (dict(num_devices=2), "Data parallelism"),
    (dict(seq_devices=2), "Sequence and 2-D parallelism"),
    (dict(model=dict(compute_dtype="bfloat16", packed=False)), "bf16"),
])
def test_refuses_unported_settings(data_dir, change, item):
    """Data parallelism runs one process a device (tests/test_torch_parallel.py):
    outside a process group a Trainer is one rank, so num_devices=2 is
    refused with how to start two ranks, as is a global batch that the
    world does not divide; num_devices=1 trains. Sequence parallelism runs
    on a group of ranks (tests/test_torch_seq_*.py): seq_devices=2 builds
    and fits an epoch on two gloo ranks; outside a group it is refused with
    how to start them, and bad widths with the JAX trainer's messages. bf16
    runs on every route, the dense layout included: a Trainer builds there
    for training and for ``--test`` alike, and any other compute_dtype is
    refused for both."""
    cfg = load_config(write_cfg(data_dir, "refuse"))
    if item == "Data parallelism":
        with pytest.raises(ValueError, match="num_devices=2, but this process is one of 1 "
                                             "rank.*main --num_devices 2"):
            Trainer(dataclasses.replace(cfg, **change), device="cpu")
        with pytest.raises(ValueError, match=r"batch_size \(3\) must be divisible by the "
                                             r"number of devices \(2\)"):
            check_world(dataclasses.replace(cfg, **change), 2)
        assert Trainer(dataclasses.replace(cfg, num_devices=1), device="cpu").world == 1
        return
    if item == "Sequence and 2-D parallelism":
        seq = dataclasses.replace(cfg, **change)
        with pytest.raises(ValueError, match="seq_devices=2 runs on a group of at least 2 ranks"
                                             ".*main --num_devices N --seq_devices 2"):
            Trainer(seq, device="cpu")
        with pytest.raises(ValueError, match=r"device count \(3\) must be divisible by "
                                             r"seq_devices \(2\)"):
            check_world(dataclasses.replace(seq, num_devices=3), 3)
        with pytest.raises(ValueError, match=r"2-D mesh needs batch_size % 1 == 0 and T \(16\), "
                                             r"L \(8\) divisible by seq_devices \(3\)"):
            check_world(dataclasses.replace(cfg, seq_devices=3), 3)
        check_world(seq, 2)
        out = str(data_dir / "seq_fit.pt")
        mesh.spawn(_torch_seq_workers.fit_epochs, 2, ["cpu", "cpu"], "gloo",
                   args=(write_cfg(data_dir, "seq_fit", seq_devices=2), 1, out), timeout_s=240)
        fit = torch.load(out, weights_only=False)
        assert fit["grid"] == (1, 2) and fit["epochs"] == [1]
        assert all(np.isfinite(fit["train_loss"]))
        return
    model = dataclasses.replace(cfg.model, **change["model"])
    for test_only in (False, True):
        Trainer(dataclasses.replace(cfg, model=model), device="cpu", test_only=test_only)
        with pytest.raises(NotImplementedError, match="compute_dtype=float16"):
            Trainer(dataclasses.replace(
                cfg, model=dataclasses.replace(model, compute_dtype="float16")),
                device="cpu", test_only=test_only)


def test_trains_and_tests_at_bf16_on_the_tiny_config(data_dir, capsys):
    """The tiny config at compute_dtype bfloat16 takes the whole-layer route:
    `fit` runs two epochs with finite losses, and a test-only Trainer loads
    its checkpoint and evaluates; an fp32 parameter set throughout."""
    trainer, stats = run_port(write_cfg(data_dir, "bf16fit", compute_dtype="bfloat16"))
    assert trainer.cfg.model.compute_dtype == "bfloat16"
    assert stats["epoch"] == [1, 2] and np.isfinite(stats["train_loss"]).all()
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    cfg = load_config(write_cfg(data_dir, "bf16fit", compute_dtype="bfloat16"))
    tester = Trainer(cfg, device="cpu", test_only=True)
    assert tester.train_step is None
    with pytest.raises(RuntimeError, match="test_only"):
        tester.fit(*loaders(build_datasets, BatchLoader, cfg))
    tester.load_for_test()
    test = BatchLoader(build_datasets(cfg, test_only=True), cfg.batch_size, shuffle=False,
                       num_workers=cfg.num_workers, seed=cfg.seed)
    metrics = tester.evaluate(test)
    assert len(metrics) == 8 and all(0.0 <= v <= 1.0 for v in metrics.values())
