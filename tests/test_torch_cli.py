"""The PyTorch port's CLI (``python -m video_moment_localization_tpu_torch.main``)
end to end on the CPU, in process, as tests/test_cli.py drives the JAX CLI:
train -> stats and checkpoint -> resume -> --test -> --test --nms, the
missing-checkpoint error, GloVe from $GLOVE_PATH, --best, --compat_metrics,
--debug_nans, --profile_dir, training and --test at bf16, the card as the
default device, --distributed as the one rank of a group, the refusal of
data-parallel and sequence-parallel settings that cannot run."""

import functools
import json
import os
import shutil
import socket
import subprocess
import sys

import pytest
import torch

from _torch_train_common import TINY_CFG
from video_moment_localization_tpu_torch.data.synthetic import write_charades_style_dir
from video_moment_localization_tpu_torch.main import main
from video_moment_localization_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A Charades-style data directory whose GloVe file lives outside it, so
    the datasets find it only through $GLOVE_PATH."""
    root = tmp_path_factory.mktemp("torch_cli")
    write_charades_style_dir(str(root / "data"), num_videos=4, queries_per_video=2)
    shutil.move(str(root / "data" / "glove"), str(root / "glove"))
    return root


@pytest.fixture
def env(workdir, monkeypatch):
    monkeypatch.setenv("GLOVE_PATH", str(workdir / "glove" / "glove.6B.300d.txt"))
    monkeypatch.chdir(workdir)
    return workdir


def write_cfg(workdir, resume=False, name="tiny", ckpt="ckpt"):
    path = workdir / f"{name}.yml"
    path.write_text(TINY_CFG.format(ckpt=str(workdir / ckpt), data=str(workdir / "data"),
                                    resume=str(resume)))
    return str(path)


def run(capsys, *args):
    capsys.readouterr()
    main([*args, "--device", "cpu"])
    return capsys.readouterr().out


def test_train_then_resume_then_test(env, capsys):
    cfg = write_cfg(env)
    out = run(capsys, "--config_path", cfg, "--num_epochs", "2")
    assert "Training Epoch - 1" in out and "Training Epoch - 2" in out
    assert "Training Loss -" in out
    assert "train_R@1, IoU=0.5 -" in out and "eval_R@5, IoU=0.7 -" in out

    stats_path = env / "ckpt/tiny_stats.json"
    stats = json.loads(stats_path.read_text())
    assert stats["epoch"] == [1, 2]
    assert len(stats["train_loss"]) == 2 and len(stats["eval_R@1, IoU=0.3"]) == 2
    assert os.path.exists(env / "ckpt/tiny_model.ckpt")

    # resume: continue to epoch 3, stats truncated/extended correctly
    cfg_resume = write_cfg(env, resume=True)
    out = run(capsys, "--config_path", cfg_resume, "--num_epochs", "3")
    assert "Training Epoch - 3" in out
    assert "Training Epoch - 2" not in out   # starts after the checkpoint
    stats = json.loads(stats_path.read_text())
    assert stats["epoch"] == [1, 2, 3]

    # test mode loads the checkpoint and prints the 8 metrics
    out = run(capsys, "--config_path", cfg_resume, "--test")
    lines = out.splitlines()
    assert [line.split(" - ")[0] for line in lines[:8]] == [
        f"R@{n}, IoU={m}" for n in (1, 5) for m in (0.1, 0.3, 0.5, 0.7)]
    assert lines[8].startswith("throughput - ") and len(lines) == 9
    # soft-NMS eval mode also runs
    out = run(capsys, "--config_path", cfg_resume, "--test", "--nms")
    assert "R@5, IoU=0.7 - " in out
    # the reference-compat eval: dense labels and score map
    out = run(capsys, "--config_path", cfg_resume, "--test", "--compat_metrics")
    assert "R@1, IoU=0.1 - " in out


def test_missing_checkpoint_raises(env, capsys):
    cfg = write_cfg(env, name="tiny2", ckpt="ckpt_missing")
    with pytest.raises(FileNotFoundError, match="No saved model at"):
        run(capsys, "--config_path", cfg, "--test")
    with pytest.raises(FileNotFoundError, match="No saved model at .*_model_best.ckpt"):
        run(capsys, "--config_path", cfg, "--test", "--best")


def test_save_best_then_test_best(env, capsys):
    cfg = write_cfg(env, name="tiny3", ckpt="ckpt_best")
    out = run(capsys, "--config_path", cfg, "--num_epochs", "1", "--save_best",
              "R@5, IoU=0.1")
    assert "new best eval_R@5, IoU=0.1 - " in out
    assert os.path.exists(env / "ckpt_best/tiny3_model_best.ckpt")
    out = run(capsys, "--config_path", cfg, "--test", "--best")
    assert "R@5, IoU=0.1 - " in out


def test_debug_nans_and_profile_dir(env, capsys):
    cfg = write_cfg(env, name="tiny4", ckpt="ckpt_prof")
    out = run(capsys, "--config_path", cfg, "--num_epochs", "1", "--debug_nans",
              "--profile_dir", str(env / "prof"))
    assert "Training Epoch - 1" in out
    with open(env / "prof" / "trace.json") as fh:
        assert json.load(fh)["traceEvents"]


@pytest.mark.parametrize("flags,item", [
    (["--num_devices", "2"], "Data parallelism"),
    (["--distributed"], "Data parallelism"),
    (["--seq_devices", "2"], "Sequence and 2-D parallelism"),
    (["--compute_dtype", "bfloat16", "--compat_metrics"], "bf16"),
])
def test_refuses_unported_flags(env, capsys, monkeypatch, flags, item):
    cfg = write_cfg(env, name="tiny5", ckpt="ckpt_refused")
    if item == "Data parallelism":
        # Data parallelism runs (tests/test_torch_parallel.py); the CLI
        # refuses a global batch that the ranks do not divide, more cards
        # than there are, and --distributed without a launcher's variables.
        # Under a launcher's variables it trains as the one rank of a group.
        if flags[0] == "--num_devices":
            with pytest.raises(ValueError, match=r"batch_size \(3\) must be divisible by the "
                                                 r"number of devices \(2\)"):
                run(capsys, "--config_path", cfg, *flags)
            with open(cfg, "a") as fh:
                fh.write("batch_size: 4\n")
            with pytest.raises(ValueError, match="requested 2 devices, only .* available"):
                main(["--config_path", cfg, *flags])   # on the card, the default device
        else:
            for var in mesh.LAUNCHER_VARIABLES + ("LOCAL_RANK",):
                monkeypatch.delenv(var, raising=False)
            with pytest.raises(ValueError, match="RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT "
                                                 "not set"):
                run(capsys, "--config_path", cfg, *flags)
            with socket.socket() as sock:   # a free port of this host for the store
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            for var, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                               ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port))):
                monkeypatch.setenv(var, value)
            out = run(capsys, "--config_path", write_cfg(env, name="tiny5r", ckpt="ckpt_rank"),
                      "--num_epochs", "1", *flags)
            assert "Training Epoch - 1" in out and "Training Loss -" in out
            assert os.path.exists(env / "ckpt_rank/tiny5r_model.ckpt")
            assert not torch.distributed.is_initialized()
        assert not os.path.exists(env / "ckpt_refused")
        return
    if item == "bf16":
        # bf16 runs on every route: with --compat_metrics (compat_head: the
        # packed unit loop), and on the dense layout (packed: False: K8 and
        # the dense blocks), which trains an epoch and tests; only
        # sequence parallelism is still refused.
        out = run(capsys, "--config_path", write_cfg(env, name="tiny5c", ckpt="ckpt_bf16_compat"),
                  "--num_epochs", "1", *flags)
        assert "Training Epoch - 1" in out
        dense = write_cfg(env, name="tiny5d", ckpt="ckpt_bf16_dense")
        with open(dense, "a") as fh:
            fh.write("packed:             False\n")
        dense_flags = ["--compute_dtype", "bfloat16"]
        out = run(capsys, "--config_path", dense, "--num_epochs", "1", *dense_flags)
        assert "Training Epoch - 1" in out and "Training Loss -" in out
        assert os.path.exists(env / "ckpt_bf16_dense/tiny5d_model.ckpt")
        lines = run(capsys, "--config_path", dense, "--test", *dense_flags).splitlines()
        assert [line.split(" - ")[0] for line in lines[:8]] == [
            f"R@{n}, IoU={m}" for n in (1, 5) for m in (0.1, 0.3, 0.5, 0.7)]
        return
    # Sequence parallelism runs on a group of ranks (tests/test_torch_seq_cli.py):
    # without one it is refused with how to start them, bad widths with the
    # JAX trainer's messages; --num_devices 2 --seq_devices 2 trains an epoch.
    with pytest.raises(ValueError, match="seq_devices=2 runs on a group of at least 2 ranks.*"
                                         "main --num_devices N --seq_devices 2"):
        run(capsys, "--config_path", cfg, *flags)
    with pytest.raises(ValueError, match=r"device count \(4\) must be divisible by "
                                         r"seq_devices \(3\)"):
        run(capsys, "--config_path", cfg, "--num_devices", "4", "--seq_devices", "3")
    with pytest.raises(ValueError, match=r"2-D mesh needs batch_size % 2 == 0 and T \(16\), "
                                         r"L \(8\) divisible by seq_devices \(2\)"):
        run(capsys, "--config_path", cfg, "--num_devices", "4", *flags)
    assert not os.path.exists(env / "ckpt_refused")
    monkeypatch.setattr(mesh, "spawn", functools.partial(mesh.spawn, timeout_s=240))
    run(capsys, "--config_path", write_cfg(env, name="tiny5s", ckpt="ckpt_seq"), "--num_epochs",
        "1", "--num_devices", "2", *flags)
    with open(env / "ckpt_seq/tiny5s_stats.json") as fh:
        assert json.load(fh)["epoch"] == [1]
    assert os.path.exists(env / "ckpt_seq/tiny5s_model.ckpt")
    assert not os.path.exists(env / "ckpt_refused")


def test_trains_and_tests_at_bf16(env, capsys):
    """``--compute_dtype bfloat16`` on the tiny config (the whole-layer
    route): an epoch of training, then ``--test`` printing the 8 metrics."""
    cfg = write_cfg(env, name="tiny7", ckpt="ckpt_bf16")
    out = run(capsys, "--config_path", cfg, "--num_epochs", "1", "--compute_dtype", "bfloat16")
    assert "Training Epoch - 1" in out and "Training Loss -" in out
    assert os.path.exists(env / "ckpt_bf16/tiny7_model.ckpt")
    out = run(capsys, "--config_path", cfg, "--test", "--compute_dtype", "bfloat16")
    lines = out.splitlines()
    assert [line.split(" - ")[0] for line in lines[:8]] == [
        f"R@{n}, IoU={m}" for n in (1, 5) for m in (0.1, 0.3, 0.5, 0.7)]


def test_runs_on_the_card_by_default(env):
    cfg = write_cfg(env, name="tiny6", ckpt="ckpt_card")
    out = subprocess.run([sys.executable, "-m", "video_moment_localization_tpu_torch.main",
                          "--config_path", cfg, "--num_epochs", "1"], cwd=str(env),
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "Trainer: no CUDA device; pass device='cpu'" in out.stderr
