"""The JAX guard: no run loads JAX, Flax or the JAX package, compared by
whole top-level names, and the reference loads nothing of the port."""

import json
import os
import subprocess
import sys

from h100_bench.lib.harness import forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_top_level_names_are_compared_whole():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla_client": 1, "flax.linen": 1,
            "video_moment_localization_tpu": 1, "video_moment_localization_tpu.models": 1,
            "video_moment_localization_tpu_torch": 1, "video_moment_localization_tpu_torch.ops": 1,
            "jaxtyping": 1, "numpy": 1, "flaxen": 1}
    assert forbidden_modules(mods) == sorted([
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "video_moment_localization_tpu",
        "video_moment_localization_tpu.models"])


def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_port():
    mods = _modules_after("import h100_bench.reference.smin, h100_bench.reference.train, "
                          "h100_bench.reference.featurize, h100_bench.reference.labels")
    tops = {m.split(".")[0] for m in mods}
    assert "video_moment_localization_tpu_torch" not in tops
    assert not tops & {"jax", "jaxlib", "flax", "video_moment_localization_tpu"}


def test_a_whole_run_loads_no_jax(tmp_path):
    """A tiny run of every cell on the CPU, in a process of its own."""
    code = ("import sys, time; sys.path.insert(0, 'h100_bench/tests'); import tiny\n"
            f"root = tiny.tiny_root({str(tmp_path)!r})\n"
            "from h100_bench.lib import harness\n"
            "import json\n"
            "for cell in [w['name'] for w in json.load(open(root + '/BENCHMARK.json'))['workloads']]:\n"
            "    r = harness.run(root, cell, 7, 0.5, False, 'cpu', time.time())\n"
            "    assert r['correct'], (cell, r)\n"
            "assert not harness.forbidden_modules(), harness.forbidden_modules()")
    mods = _modules_after(code)
    tops = {m.split(".")[0] for m in mods}
    assert "video_moment_localization_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "video_moment_localization_tpu"}


def test_run_refuses_without_a_card(tmp_path):
    """No result and a non-zero exit where there is no CUDA device (this
    sandbox), and in a directory that holds only the benchmark's files."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "h100_bench"), tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    for cwd in (ROOT, str(tmp_path)):
        out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                              "charades.serve.grouped", "--seed", "3", "--seconds", "1",
                              "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                             timeout=300, env={k: v for k, v in os.environ.items()
                                               if k != "PYTHONPATH"})
        assert out.returncode != 0
        assert out.stdout.strip() == ""
