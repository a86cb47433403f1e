"""``--seq_devices`` through the PyTorch port's CLI (``main``, in process) on
the CPU: the 2-D (data x seq) grid of gloo ranks that ``--num_devices N``
starts (`parallel.mesh.spawn`), as tests/test_cli_seq.py drives the JAX CLI.

* ``--num_devices 2 --seq_devices 2`` (1 x 2) and ``--num_devices 4
  --seq_devices 2`` (2 x 2): epoch 1's stats within 2e-4 of one process's
  (the JAX CLI test allows 1e-3), stdout, the stats file and the
  checkpoint written once;
* a 1 + 1 resume at (1 x 2) equal to the uninterrupted two epochs;
* ``--test --nms`` at (1 x 2) printing its 8 metrics once;
* ``--compat_metrics`` switching the grid to the dense layout, said once;
* the devices and backend ``--num_devices`` gives its ranks: NCCL when each
  rank has a card of its own, gloo when they share one or run on the CPU.

The refusals (no group of ranks, ``--num_devices 4 --seq_devices 3``, bad
widths) are cases of tests/test_torch_cli.py::test_refuses_unported_flags.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from _torch_train_common import TINY_CFG
from test_torch_parallel import fd_stdout
from video_moment_localization_tpu_torch.data.synthetic import write_charades_style_dir
from video_moment_localization_tpu_torch.main import main
from video_moment_localization_tpu_torch.parallel import mesh

TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq_cli")
    write_charades_style_dir(str(root / "data"), queries_per_video=2,
                             videos_per_split={"train": 5, "test": 3})
    return root


def cli_cfg(root, name, resume=False):
    path = root / f"{name}.yml"
    path.write_text(TINY_CFG.format(ckpt=str(root / name), data=str(root / "data"),
                                    resume=resume) + "batch_size: 4\n")
    return str(path)


def stats_of(root, name):
    with open(root / name / f"{name}_stats.json") as fh:
        return json.load(fh)


SEQ2 = ["--num_devices", "2", "--seq_devices", "2"]


@pytest.fixture(scope="module")
def cli_runs(cli_dir):
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        mp.setattr(mesh, "spawn", functools.partial(mesh.spawn, timeout_s=TIMEOUT_S))
        for name, argv in (
                ("single", ["--config_path", cli_cfg(cli_dir, "single"), "--num_epochs", "1"]),
                ("seq2", ["--config_path", cli_cfg(cli_dir, "seq2"), "--num_epochs", "2", *SEQ2]),
                ("grid", ["--config_path", cli_cfg(cli_dir, "grid"), "--num_epochs", "1",
                          "--num_devices", "4", "--seq_devices", "2"]),
                ("cut1", ["--config_path", cli_cfg(cli_dir, "cut"), "--num_epochs", "1", *SEQ2]),
                ("cut2", ["--config_path", cli_cfg(cli_dir, "cut", resume=True), "--num_epochs",
                          "2", *SEQ2]),
                ("test", ["--config_path", cli_cfg(cli_dir, "seq2"), "--test", "--nms", *SEQ2]),
                ("compat", ["--config_path", cli_cfg(cli_dir, "compat"), "--num_epochs", "1",
                            "--compat_metrics", *SEQ2])):
            out[name] = fd_stdout(lambda: main([*argv, "--device", "cpu"]))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", ["seq2", "grid"])
def test_cli_seq_matches_one_process(cli_dir, cli_runs, name):
    got, single = stats_of(cli_dir, name), stats_of(cli_dir, "single")
    assert got["epoch"][0] == 1 and single["epoch"] == [1]
    for key, vals in single.items():
        np.testing.assert_allclose(got[key][0], vals[0], rtol=2e-4, atol=2e-4, err_msg=key)


@pytest.mark.parametrize("name", ["seq2", "grid"])
def test_cli_seq_writes_once(cli_dir, cli_runs, name):
    out = cli_runs[name]
    epochs = 2 if name == "seq2" else 1
    for e in range(1, epochs + 1):
        assert out.count(f"Training Epoch - {e}") == 1
    assert out.count("throughput - ") == epochs
    assert sorted(os.listdir(cli_dir / name)) == [f"{name}_model.ckpt", f"{name}_stats.json"]
    assert torch.load(cli_dir / name / f"{name}_model.ckpt", weights_only=True)["epoch"] == epochs


def test_cli_seq_resume_equals_the_uninterrupted_run(cli_dir, cli_runs):
    assert "Training Epoch - 2" in cli_runs["cut2"]
    assert "Training Epoch - 1" not in cli_runs["cut2"]
    assert stats_of(cli_dir, "cut") == stats_of(cli_dir, "seq2")
    a = torch.load(cli_dir / "seq2" / "seq2_model.ckpt", weights_only=True)["model"]
    b = torch.load(cli_dir / "cut" / "cut_model.ckpt", weights_only=True)["model"]
    for name, p in a.items():
        assert torch.equal(p, b[name]), name


def test_cli_seq_test_prints_the_metrics_once(cli_runs):
    lines = cli_runs["test"].splitlines()
    names = [f"R@{n}, IoU={m}" for n in (1, 5) for m in (0.1, 0.3, 0.5, 0.7)]
    assert [line.split(" - ")[0] for line in lines[:8]] == names
    assert lines[8].startswith("throughput - ") and len(lines) == 9
    assert all(0.0 <= float(line.split(" - ")[1]) <= 1.0 for line in lines[:8])


def test_cli_seq_compat_switches_to_the_dense_layout(cli_dir, cli_runs):
    out = cli_runs["compat"]
    assert out.count("2-D (data x seq) mesh + compat_head: dense row-sharded layout "
                     "(packed=False)") == 1
    assert out.count("Training Epoch - 1") == 1
    assert np.isfinite(stats_of(cli_dir, "compat")["train_loss"][0])


@pytest.mark.parametrize("device, cards, devices, backend", [
    ("cuda", 2, ["cuda:0", "cuda:1"], "nccl"),
    ("cuda:0", 1, ["cuda:0", "cuda:0"], "gloo"),
    ("cpu", 0, ["cpu", "cpu"], "gloo"),
])
def test_cli_seq_places_the_ranks(cli_dir, monkeypatch, device, cards, devices, backend):
    spawned = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(mesh, "spawn", lambda fn, n, devs, **kw: spawned.append((n, devs)))
    main(["--config_path", cli_cfg(cli_dir, "place"), "--num_epochs", "1", *SEQ2,
          "--device", device])
    assert spawned == [(2, devices)]
    assert mesh.spawn_backend(devices) == backend
