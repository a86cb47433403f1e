"""A tiny copy of the benchmark for the CPU tests: every driver, reader and
reference as they are, on configurations cut to a size the CPU runs in
seconds (T=8, L=4, d=32, 2 SMI layers) and small pools, under the cell names
of BENCHMARK.json."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
REPO = os.path.dirname(BENCH)

TINY = {"T": 8, "L": 4, "C": 2, "d": 32, "dl": 16, "lstm_hidden_size": 16,
        "num_smi_layers": 2, "input_video_dim": 24, "max_query_length": 6, "word_dim": 300,
        "vocab_size": 50}


def tiny_root(dst: str) -> str:
    """A checkout root under ``dst`` with the benchmark's files and tiny
    configurations and mixes under the same cell names."""
    shutil.copytree(BENCH, os.path.join(dst, "h100_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    for c in bench["configs"]:
        path = os.path.join(dst, c["file"])
        with open(path) as fh:
            cfg = json.load(fh)
        cfg.update(TINY)
        with open(path, "w") as fh:
            json.dump(cfg, fh)
    for w in bench["workloads"]:
        path = os.path.join(dst, "h100_bench", "workloads", w["traffic"] + ".json")
        with open(path) as fh:
            cell = json.load(fh)
        shrink(cell)
        with open(path, "w") as fh:
            json.dump(cell, fh)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), os.path.join(dst, "BENCHMARK.json"))
    return dst


def shrink(cell: dict) -> None:
    t = cell["traffic"]
    if cell["driver"] == "train_step":
        t.update(pool=4, batch=6)
        cell["check"]["block"] = 4
        return
    t["videos"] = {"pool": 16, "clips": [2, 20]}
    t["cycle_chunks"] = 3
    nq = t["chunk"]["queries_per_video"]
    t["chunk"]["videos"] = 8 // nq
    cell["localizer"]["serve_batch"] = 8
    cell["check"]["sample"] = 6
    cell["check"]["block"] = 4


def load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)
