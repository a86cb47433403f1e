"""The leftovers that complete the PyTorch port, on the CPU:

* `models.smin.attention_weights_sink` against the JAX package's sink on the
  same un-jitted forward from the same weights and inputs: the same names in
  the same order with the same shapes, values within 1e-5, on the packed,
  dense and ``compat_head`` routes; re-entrant, restoring the outer sink;
* ``utils/simpletest.py`` and ``utils/bench_data.py`` (the JAX package's
  ``scripts/simpletest.py`` and ``scripts/bench_data.py``) run on the CPU on
  the synthetic data; the HDF5 datasets skipped with a message without
  ``h5py``;
* ``utils/parity_run.py``: ``gen`` writes the JAX script's fixture and
  config byte for byte, ``export-init`` then ``ours`` trains the port from
  those weights (loaded strictly) and writes the reference stats schema, and
  ``report`` compares two runs' stats files.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_common import (
    CFG,
    JCFG,
    MODES,
    SHAPE,
    TINY_CFG,
    make_batch,
    make_model,
    mode_configs,
)
from video_moment_localization_tpu.data.synthetic import write_charades_style_dir as j_write
from video_moment_localization_tpu.models import smin_forward as j_smin_forward
from video_moment_localization_tpu.models.smin import attention_weights_sink as j_sink
from video_moment_localization_tpu_torch.models.smin import attention_weights_sink, smin_forward
from video_moment_localization_tpu_torch.utils import bench_data, parity_run, simpletest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("video_features", "video_mask", "query_features", "query_mask", "length_mask",
        "moment_mask")


@pytest.mark.parametrize("mode", ["packed", "dense", "compat"])
def test_sink_matches_jax(mode):
    if mode == "packed":
        jcfg, cfg, shape = JCFG, CFG, None
    else:
        (jcfg, cfg), shape = mode_configs(mode), dict(SHAPE, **MODES[mode])
    params, model = make_model(3, shape)
    b = make_batch(B=3, seed=5, cfg=cfg, packed_labels=mode == "packed")
    with j_sink() as want:
        j_smin_forward(params, jcfg, *(jnp.asarray(b[k]) if k in b else None for k in KEYS))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with torch.no_grad(), attention_weights_sink() as got:
        smin_forward(model, cfg, *(tb.get(k) for k in KEYS))
    layers = cfg.num_smi_layers
    assert [n for n, _ in got] == [n for n, _ in want] == ["content", "word"] * layers
    N = cfg.L * (cfg.L + 1) // 2
    cells = (cfg.L, cfg.L) if mode == "dense" else (N,)
    for (name, g), (_, w) in zip(got, want):
        shape = (3, *cells, cfg.C, cfg.max_query_length) if name == "content" else (
            3, cfg.L, cfg.max_query_length)
        assert tuple(g.shape) == tuple(w.shape) == shape
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


def test_sink_is_reentrant():
    _, model = make_model(3)
    tb = {k: torch.from_numpy(v) for k, v in make_batch(B=2, seed=6).items()}
    with torch.no_grad(), attention_weights_sink() as outer:
        with attention_weights_sink() as inner:
            smin_forward(model, CFG, *(tb.get(k) for k in KEYS))
        assert len(inner) == 2 * CFG.num_smi_layers and outer == []
        smin_forward(model, CFG, *(tb.get(k) for k in KEYS))
    assert len(outer) == 2 * CFG.num_smi_layers
    with torch.no_grad():
        smin_forward(model, CFG, *(tb.get(k) for k in KEYS))
    assert len(outer) == 2 * CFG.num_smi_layers      # no sink open: nothing recorded


def test_simpletest_runs_on_the_cpu(capsys):
    out = simpletest.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert printed.strip().endswith("OK")
    assert out["shapes"]["content"] == (4, 8, 8, 4, 64) and out["pm_shape"] == (4, 8, 8)
    assert 0.2 < out["mean_pm"] < 0.8 and 0.2 < out["mean_ps"] < 0.8


def test_simpletest_takes_a_config(tmp_path, capsys):
    path = tmp_path / "tiny.yml"
    path.write_text(TINY_CFG.format(ckpt=str(tmp_path), data=str(tmp_path), resume=False))
    out = simpletest.main(["--config_path", str(path), "--device", "cpu"])
    assert out["shapes"]["boundary"] == (4, 8, 32)


def test_bench_data_falls_back_to_the_synthetic_dir(tmp_path, capsys):
    res = bench_data.main(["--data_root", str(tmp_path), "--num_workers", "1"])
    printed = capsys.readouterr().out
    assert "No real datasets found" in printed
    assert [r["name"] for r in res] == ["CharadesSTA(synthetic)"] and res[0]["samples"] == 256


def test_bench_data_skips_hdf5_without_h5py(tmp_path, capsys, monkeypatch):
    j_write(str(tmp_path / "charades"), num_videos=3)
    os.makedirs(tmp_path / "tacos")
    (tmp_path / "tacos" / "train.json").write_text("{}")
    monkeypatch.setenv("GLOVE_PATH", str(tmp_path / "charades/glove/glove.6B.300d.txt"))
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "h5py" else real(name, *a))
    res = bench_data.main(["--data_root", str(tmp_path), "--batch_size", "4",
                           "--num_workers", "1"])
    printed = capsys.readouterr().out
    assert "TACoS: h5py is not installed, skipping" in printed
    assert [r["name"] for r in res] == ["CharadesSTA"] and res[0]["samples"] == 6


def load_jax_script():
    spec = importlib.util.spec_from_file_location("jax_parity_run",
                                                  os.path.join(REPO, "scripts", "parity_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_parity_gen_writes_the_jax_fixture(tmp_path):
    jscript = load_jax_script()
    assert parity_run.CONFIG_TEMPLATE == jscript.CONFIG_TEMPLATE
    assert parity_run.PRESETS == jscript.PRESETS
    argv = ["--train-videos", "3", "--test-videos", "2", "--queries", "2", "--seed", "5"]
    parity_run.main(["gen", "--root", str(tmp_path / "port"), *argv])
    args = jscript.argparse.Namespace(root=str(tmp_path / "jax"), preset="charades",
                                      train_videos=3, test_videos=2, queries=2, signal=1.2,
                                      seed=5, epochs=10, smi_layers=3)
    jscript.cmd_gen(args)
    for dirpath, _, files in os.walk(tmp_path / "jax"):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), tmp_path / "jax")
            with open(tmp_path / "jax" / rel, "rb") as a, open(tmp_path / "port" / rel, "rb") as b:
                want, got = a.read(), b.read()
            if name == "parity.yml":
                want = want.replace(str(tmp_path / "jax").encode(), str(tmp_path / "port").encode())
            assert got == want, rel


@pytest.fixture(scope="module")
def parity_dirs(tmp_path_factory):
    """export-init, then two `ours` runs of one epoch on a tiny config of a
    Charades-style fixture from those weights (seeds 43 and 44)."""
    root = tmp_path_factory.mktemp("parity")
    j_write(str(root / "data"), queries_per_video=2, videos_per_split={"train": 4, "test": 2})
    cfg = root / "parity.yml"
    cfg.write_text(TINY_CFG.format(ckpt=str(root / "ckpt"), data=str(root / "data"),
                                   resume=False))
    parity_run.main(["export-init", "--config", str(cfg), "--out", str(root / "init.pt")])
    dirs = []
    for seed in (43, 44):
        out = root / f"port_s{seed}"
        parity_run.main(["ours", "--config", str(cfg), "--out-dir", str(out), "--epochs", "1",
                         "--seed", str(seed), "--init", str(root / "init.pt"), "--device",
                         "cpu"])
        dirs.append(out)
    return root, dirs


def test_parity_ours_trains_from_the_shared_weights(parity_dirs):
    root, dirs = parity_dirs
    init = torch.load(root / "init.pt", weights_only=False)
    assert init["epoch"] == 0 and "backbone.videoencoder.pe.weight" in init["model"]
    for d in dirs:
        assert sorted(os.listdir(d)) == ["init_eval.json", "parity_model.ckpt",
                                         "parity_stats.json", "wallclock.json"]
        stats = json.loads((d / "parity_stats.json").read_text())
        assert stats["epoch"] == [1] and f"eval_{parity_run.METRICS[0]}" in stats
    evals = [json.loads((d / "init_eval.json").read_text()) for d in dirs]
    # The epoch-0 eval has no shuffle and no jitter: the same from the same weights.
    assert evals[0]["eval_loss"] == evals[1]["eval_loss"]


def test_parity_report_compares_two_runs(parity_dirs, tmp_path, capsys):
    _, dirs = parity_dirs
    jax_dir = tmp_path / "jax"
    os.makedirs(jax_dir)
    stats = json.loads((dirs[0] / "parity_stats.json").read_text())
    stats[f"eval_{parity_run.METRICS[0]}"][-1] += 0.25
    (jax_dir / "parity_stats.json").write_text(json.dumps(stats))
    (jax_dir / "init_eval.json").write_text((dirs[0] / "init_eval.json").read_text())
    out = tmp_path / "report.md"
    lines = parity_run.main(["report", "--jax-dirs", str(jax_dir), "--port-dirs",
                             str(dirs[0]), str(dirs[1]), "--out", str(out)])
    assert out.read_text() == "\n".join(lines) + "\n"
    assert "| eval_loss |" in out.read_text() and "| JAX s1 | port s1 | port s2 |" in \
        out.read_text().replace(" train_loss:", "")
    gap = [line for line in lines if line.startswith(f"| {parity_run.METRICS[0]} |")][-1]
    assert float(gap.split("|")[5]) == pytest.approx(
        np.mean([json.loads((d / "parity_stats.json").read_text())[
            f"eval_{parity_run.METRICS[0]}"][-1] for d in dirs])
        - stats[f"eval_{parity_run.METRICS[0]}"][-1], abs=1e-4)
