"""A cell, a configuration, a traffic mix and a per-layer metric are added
as new files plus entries in BENCHMARK.json, and the harness finds them
without an edit to any file it had."""

import json
import os
import time

import pytest

from h100_bench.lib import harness, spec


def add_files(root):
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as fh:
        bench = json.load(fh)
    with open(os.path.join(root, "h100_bench", "configs", "charades.json")) as fh:
        cfg = json.load(fh)
    cfg.update(num_smi_layers=1)
    with open(os.path.join(root, "h100_bench", "configs", "dummy.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(root, "h100_bench", "workloads",
                           "charades.serve.grouped.json")) as fh:
        cell = json.load(fh)
    cell["config"] = "dummy"
    cell["traffic"]["query_words"] = [1, 2]
    with open(os.path.join(root, "h100_bench", "workloads", "dummy.serve.json"), "w") as fh:
        json.dump(cell, fh)
    with open(os.path.join(root, "h100_bench", "metrics", "dummy_chunks.pairs.py"), "w") as fh:
        fh.write("def read(record):\n    return float(record.steps)\n")
    bench["configs"].append({"name": "dummy", "source": "a test", "file":
                             "h100_bench/configs/dummy.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.serve", "config": "dummy",
                               "traffic": "dummy.serve", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "pairs_per_s":
            m["workloads"].append("dummy.serve")
    bench["per_layer"].append({"name": "dummy_chunks.pairs", "unit": "chunks",
                               "better": "higher", "source": "program_counter",
                               "layer": "inference host path", "moves": "pairs_per_s",
                               "workloads": ["dummy.serve"]})
    with open(bench_path, "w") as fh:
        json.dump(bench, fh)


def test_new_files_are_found(tiny):
    before = {os.path.join(d, f): open(os.path.join(d, f), "rb").read()
              for d, _, fs in os.walk(os.path.join(tiny, "h100_bench")) for f in fs
              if not f.endswith(".pyc")}
    add_files(tiny)
    for path, data in before.items():
        with open(path, "rb") as fh:
            assert fh.read() == data, f"{path} was edited"
    cell = spec.load_cell(tiny, "dummy.serve")
    assert cell.config["num_smi_layers"] == 1
    assert [m["name"] for m in cell.per_layer] == ["dummy_chunks.pairs"]
    assert {m["name"] for m in cell.end_to_end} == {"pairs_per_s", "setup_s"}
    out = harness.run(tiny, "dummy.serve", 99, 0.3, True, "cpu", time.time())
    assert out["correct"]
    assert out["metrics"]["dummy_chunks.pairs"]["value"] > 0
    out = harness.run(tiny, "dummy.serve", 99, 0.3, False, "cpu", time.time())
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}


def test_a_metric_without_a_list_follows_its_end_to_end_metric(tiny):
    bench_path = os.path.join(tiny, "BENCHMARK.json")
    with open(bench_path) as fh:
        bench = json.load(fh)
    for m in bench["per_layer"]:
        if m["name"] == "mfu.pairs":
            del m["workloads"]
    with open(bench_path, "w") as fh:
        json.dump(bench, fh)
    assert "mfu.pairs" in {m["name"] for m in spec.load_cell(tiny, "charades.serve.grouped").per_layer}
    assert "mfu.pairs" not in {m["name"] for m in spec.load_cell(tiny, "anet.train").per_layer}


@pytest.mark.parametrize("bad", ["../x", "a b", "", "a/b", "é"])
def test_names_are_checked(bad):
    with pytest.raises(ValueError):
        spec.check_name(bad)


def test_a_missing_piece_is_named(tiny):
    with pytest.raises(KeyError, match="no workload"):
        spec.load_cell(tiny, "nope")
    with pytest.raises(FileNotFoundError, match="no metric named"):
        spec.load_module(tiny, "metrics", "nope")
