"""The control on the card: the reference in TF32 (the precision below the
configurations' fp32 with TF32 off) put in the program's place fails the
cells' limits, at a size a test run holds. The full-size readings come from
``tools/calibrate.py``. Skips where there is no CUDA device."""

import json
import os
import time

import pytest

from h100_bench.lib import checks, harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def shrunk_root(tmp_path, cell, update):
    import shutil

    shutil.copytree(os.path.join(ROOT, "h100_bench"), tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    path = tmp_path / "h100_bench" / "workloads" / (cell + ".json")
    data = json.loads(path.read_text())
    update(data)
    path.write_text(json.dumps(data))
    return str(tmp_path)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,update", [
    ("anet.train", lambda w: w["traffic"].update(batch=16)),
    ("charades.serve.grouped", lambda w: w.update(traffic=dict(w["traffic"], cycle_chunks=2))),
])
def test_control_fails_a_limit(card, tmp_path, cell, update):
    root = shrunk_root(tmp_path, cell, update)
    seen = {}

    def hook(ctx, driver, state, record, readings):
        seen["program"] = readings
        seen["control"] = driver.control(ctx, state, record)["tf32"]

    out = harness.run(root, cell, 2 ** 31 + 5, 1.0, False, card, time.time(), after_check=hook)
    limits = json.load(open(os.path.join(root, "h100_bench", "workloads", cell + ".json")))
    limits = limits["check"]["limits"]
    assert out["correct"], out["checks"]
    assert not checks.passed(checks.judge(seen["control"], limits)), seen
