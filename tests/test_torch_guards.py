"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
its entry points default to the card and take every mode of the JAX package
in fp32 and bf16, refusing any other compute_dtype, its kernel path names no
library kernel, and chip_smoke.py fails without a card."""

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
from video_moment_localization_tpu_torch.models.smin import (
    SMIN,
    smin_forward,
    smin_forward_inference,
)
from video_moment_localization_tpu_torch.ops.cuda_build import refuse_grad
from video_moment_localization_tpu_torch.parallel.steps import make_eval_step, make_train_step

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
            "import video_moment_localization_tpu_torch.utils.profile_train\n"
            "import video_moment_localization_tpu_torch.parallel.steps\n"
            "import video_moment_localization_tpu_torch.ops.proposal_cuda\n"
            "import video_moment_localization_tpu_torch.ops.smin_train_cuda\n"
            "import video_moment_localization_tpu_torch.ops.content_cuda\n"
            "import video_moment_localization_tpu_torch.ops.gemm_cuda\n"
            "import video_moment_localization_tpu_torch.main\n"
            "import video_moment_localization_tpu_torch.data.synthetic\n"
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
    model = SMIN(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(TINY, model, torch.optim.Adam(model.parameters()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_eval_step(TINY, model)


def _tiny_args(B=2):
    """Inputs of a TINY forward, with the dense layout's moment_mask."""
    lm = torch.ones(B, 4)
    mm = torch.triu(lm[:, :, None] * lm[:, None, :])
    return (torch.zeros(B, 8, 6), torch.ones(B, 8, 1), torch.zeros(B, 4, 300),
            torch.ones(B, 4, 1), lm, mm)


def _assert_scores(cfg, outputs, B=2):
    pm, ps, pe, pa = outputs
    dense = not cfg.packed or cfg.compat_head
    assert tuple(pm.shape) == ((B, 4, 4) if dense else (B, 10))
    for x in (pm, ps, pe, pa):
        assert torch.isfinite(x).all() and (x >= 0).all() and (x <= 1).all()


@pytest.mark.parametrize("change", [dict(compute_dtype="bfloat16"), dict(compat_head=True),
                                    dict(fused_smi=False), dict(fused_lstm=False),
                                    dict(packed=False)])
def test_modes_outside_the_slice_raise(change):
    """The slice is every mode of the JAX package's serving forward in fp32
    and bf16: each of the other modes runs, bf16 runs on the default route
    and, through smin_forward, under compat_head, fused_smi: False and
    packed: False (fp32 scores); any other compute_dtype raises."""
    import dataclasses

    cfg = dataclasses.replace(TINY, **change)
    _assert_scores(cfg, smin_forward_inference(SMIN(cfg), cfg, *_tiny_args()))
    if cfg.compute_dtype == "bfloat16":
        assert all(o.dtype == torch.float32 for o in
                   smin_forward_inference(SMIN(cfg), cfg, *_tiny_args()))
        for other in (dict(compat_head=True), dict(fused_smi=False), dict(packed=False)):
            served = dataclasses.replace(cfg, **other)
            outputs = smin_forward_inference(SMIN(served), served, *_tiny_args())
            _assert_scores(served, outputs)
            assert all(o.dtype == torch.float32 for o in outputs)
            MomentLocalizer(served, SMIN(served), WordEmbedding.synthetic(["a"], dim=300),
                            device="cpu")
        bad = dataclasses.replace(cfg, compute_dtype="float16")
        with pytest.raises(NotImplementedError, match="not supported by the PyTorch port"):
            smin_forward_inference(SMIN(bad), bad, *_tiny_args())
        with pytest.raises(NotImplementedError, match="compute_dtype=float16"):
            MomentLocalizer(bad, SMIN(bad), WordEmbedding.synthetic(["a"], dim=300),
                            device="cpu")


@pytest.mark.parametrize("change", [dict(compute_dtype="bfloat16"), dict(compat_head=True),
                                    dict(fused_smi_train=False), dict(remat_smi=True),
                                    dict(packed=False)])
def test_training_modes_outside_the_slice_raise(change):
    """The slice is every mode of the JAX package's training forward and
    step in fp32 and bf16: each mode runs (TINY at bf16 takes the
    whole-layer route, fp32 scores), bf16 under compat_head and
    fused_smi_train: False runs the packed unit loop and under packed: False
    the dense one (fp32 scores); any other compute_dtype raises."""
    import dataclasses

    cfg = dataclasses.replace(TINY, **change)
    model = SMIN(cfg)
    make_train_step(cfg, model, torch.optim.Adam(model.parameters()), device="cpu")
    outputs = smin_forward(model, cfg, *_tiny_args())
    _assert_scores(cfg, outputs)
    if cfg.compute_dtype == "bfloat16":
        assert all(o.dtype == torch.float32 for o in outputs)
        for other in (dict(compat_head=True), dict(fused_smi_train=False),
                      dict(packed=False)):
            loop = dataclasses.replace(cfg, **other)
            make_train_step(loop, SMIN(loop), torch.optim.Adam(model.parameters()),
                            device="cpu")
            loop_out = smin_forward(SMIN(loop), loop, *_tiny_args())
            _assert_scores(loop, loop_out)
            assert all(o.dtype == torch.float32 for o in loop_out)
        bad = dataclasses.replace(cfg, compute_dtype="float16")
        with pytest.raises(NotImplementedError, match="compute_dtype=float16"):
            smin_forward(SMIN(bad), bad, *_tiny_args())
        with pytest.raises(NotImplementedError, match="not supported by the PyTorch port"):
            make_train_step(bad, SMIN(bad), torch.optim.Adam(model.parameters()),
                            device="cpu")


def test_grad_free_wrappers_refuse_to_cut_a_graph():
    """The predicate behind the K4 / K5 wrappers' refusal on CUDA tensors:
    grad mode on and any input or weight that requires grad."""
    plain, leaf = torch.zeros(2), torch.zeros(2, requires_grad=True)
    refuse_grad("kernel", [plain, plain])
    with torch.no_grad():
        refuse_grad("kernel", [plain, leaf])
    with pytest.raises(RuntimeError, match="kernel has no backward kernel"):
        refuse_grad("kernel", [plain, leaf])



@pytest.mark.parametrize("name", ["proposal_rows", "proposal_packed", "proposal_dense"])
def test_proposal_wrappers_refuse_a_tile_over_shared_memory(name):
    """K1 / K6 / K8: a T whose tile exceeds the shared memory of one block
    (T > 899 forward, T > 1763 backward at L=16) raises ValueError before any launch;
    a T that fits passes the check (and a meta tensor then meets the device
    check). No card is needed: the checks come before the device's."""
    from video_moment_localization_tpu_torch.ops import proposal_cuda

    dense = name == "proposal_dense"
    forward = getattr(proposal_cuda, f"{name}_forward")
    backward = getattr(proposal_cuda, f"{name}_backward")
    L, C, D, B = 16, 4, 8, 2
    lead = (B, L, L) if dense else (B, L * (L + 1) // 2)

    def meta(*shape):
        return torch.zeros(*shape, device="meta")

    mask = meta(*((B, L, L) if dense else (B, L)))
    for T, refused in ((896, False), (912, True)):
        with pytest.raises(ValueError, match="shared memory" if refused else "CPU or CUDA"):
            forward(meta(B, T, D), mask, L, C)
    for T, refused in ((1760, False), (1776, True)):
        with pytest.raises(ValueError, match="shared memory" if refused else "CPU or CUDA"):
            backward(mask, T, L, C, meta(*lead, C, D), meta(*lead, D), meta(B, L, D))

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
