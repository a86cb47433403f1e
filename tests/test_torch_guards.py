"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points default to the card and refuse what the slice does not
implement, its kernel path names no library kernel, and chip_smoke.py fails
without a card."""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from video_moment_localization_tpu_torch.config import ModelConfig
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.inference import MomentLocalizer
from video_moment_localization_tpu_torch.models.smin import SMIN, smin_forward_inference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "video_moment_localization_tpu_torch")
TINY = ModelConfig(T=8, L=4, C=2, D=16, dl=8, num_smi_layers=1, input_video_dim=6,
                   max_query_length=4, lstm_hidden_size=8)
FORBIDDEN_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|video_moment_localization_tpu)(\.|\s|$)",
    re.M)


def _port_sources(suffixes):
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(suffixes):
                yield os.path.join(root, name)


def test_port_sources_import_no_jax():
    files = list(_port_sources((".py",))) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 20
    for path in files:
        with open(path) as fh:
            hits = FORBIDDEN_IMPORT.findall(fh.read())
        assert not hits, f"{path} imports {hits}"


def test_kernel_path_names_no_library_kernel():
    """The path has no cuBLAS/cuDNN call in the kernels, and no
    torch.compile or library attention anywhere in the package."""
    for path in _port_sources((".cu", ".cuh")):
        with open(path) as fh:
            text = fh.read().lower()
        assert "cublas" not in text and "cudnn" not in text and "cutlass" not in text, path
    for path in _port_sources((".py",)):
        with open(path) as fh:
            text = fh.read()
        assert "torch.compile" not in text and "scaled_dot_product_attention" not in text, path


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import video_moment_localization_tpu_torch.inference\n"
            "import video_moment_localization_tpu_torch.ops.lstm_cuda\n"
            "import video_moment_localization_tpu_torch.ops.smin_cuda\n"
            "import video_moment_localization_tpu_torch.utils.profile_serving\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'video_moment_localization_tpu')]\n"
            "print(sorted(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    emb = WordEmbedding.synthetic(["a"], dim=300)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MomentLocalizer(TINY, SMIN(TINY), emb)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MomentLocalizer(TINY, SMIN(TINY), emb, serve_batch=4, device="cuda")


@pytest.mark.parametrize("change", [dict(compute_dtype="bfloat16"), dict(compat_head=True),
                                    dict(fused_smi=False), dict(fused_lstm=False),
                                    dict(packed=False)])
def test_modes_outside_the_slice_raise(change):
    import dataclasses

    cfg = dataclasses.replace(TINY, **change)
    B = 2
    args = (torch.zeros(B, 8, 6), torch.ones(B, 8, 1), torch.zeros(B, 4, 300),
            torch.ones(B, 4, 1), torch.ones(B, 4))
    with pytest.raises(NotImplementedError, match="not supported by the PyTorch serving path"):
        smin_forward_inference(SMIN(cfg), cfg, *args)


def test_forward_outputs_are_finite_scores():
    rng = np.random.default_rng(0)
    B = 3
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    lm = torch.tensor([[1, 1, 1, 1], [1, 0, 0, 0], [0, 0, 0, 0]], dtype=torch.float32)
    qm = torch.tensor([[1, 1, 1, 0], [1, 0, 0, 0], [0, 0, 0, 0]], dtype=torch.float32)[..., None]
    pm, ps, pe, pa = smin_forward_inference(SMIN(TINY), TINY, t(B, 8, 6), torch.ones(B, 8, 1),
                                            t(B, 4, 300), qm, lm)
    assert pm.shape == (B, 10) and ps.shape == pe.shape == pa.shape == (B, 4)
    for x in (pm, ps, pe, pa):
        assert torch.isfinite(x).all() and (x >= 0).all() and (x <= 1).all()
    assert (pm[2] == 0).all() and (ps[1, 1:] == 0).all()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:        # a directory that holds chip_smoke.py and nothing else
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    out = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_port_sources_are_not_gitignored():
    """A repo-wide ignore rule (such as `data/`) must not hide a source of
    the port from the commit: a clean checkout would lack the module."""
    if shutil.which("git") is None or not os.path.isdir(os.path.join(REPO, ".git")):
        pytest.skip("not a git checkout")
    files = [os.path.relpath(p, REPO) for p in _port_sources((".py", ".cu", ".cuh"))]
    out = subprocess.run(["git", "check-ignore", "--no-index", *files], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "", f"ignored by .gitignore: {out.stdout.split()}"
