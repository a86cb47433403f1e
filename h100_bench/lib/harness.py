"""One run of one cell: set-up, the measured window, the check, the result line.

A driver (``h100_bench/drivers/<name>.py``) has three functions:

* ``setup(ctx) -> state``: builds the program's objects from the seed's
  weights and traffic, warms up every shape the cell's traffic uses and no
  other (and, for training, drives the checked first steps);
* ``window(ctx, state, seconds, tracer) -> Record``: the measured window;
* ``check(ctx, state, record) -> readings``: after the window, frees the
  program's state and holds what the window produced to the reference.

The harness times set-up from the process's start, runs the window with
tracing off (``--trace 0``: the end-to-end metrics) or on (``--trace 1``:
the per-layer metrics, read by ``h100_bench/metrics/<name>.py``), reads the
device's memory peak before the reference runs, and refuses to print a
result when a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from h100_bench.counts import flops as counts
from h100_bench.lib import checks, spec
from h100_bench.lib.trace import Tracer
from h100_bench.reference import smin as ref_smin

FORBIDDEN = ("jax", "jaxlib", "flax", "video_moment_localization_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".")[0] in FORBIDDEN)


def process_start() -> float:
    """The process's start on the ``time.time`` clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclasses.dataclass
class Context:
    cell: spec.Cell
    seed: int
    device: torch.device
    cfg: Dict                                  # the configuration file
    weights: Dict[str, torch.Tensor]           # the seed's parameters, by reference name
    seconds: float                             # the window's length

    @property
    def workload(self) -> Dict:
        return self.cell.workload

    @property
    def dtype(self) -> str:
        return self.cfg["compute_dtype"]


@dataclasses.dataclass
class Record:
    """What a window did; the per-layer readers read it."""
    e2e: Dict[str, float]                      # end-to-end metric name -> value
    attempted: int
    failed: int
    units: int = 0                             # pairs, requests or valid samples completed
    flops: float = 0.0                         # their work by the frozen count
    nbytes: float = 0.0
    steps: int = 0                             # chunks, batches or train steps completed
    window_s: float = 0.0
    spans: List = dataclasses.field(default_factory=list)
    busy_s: Optional[float] = None             # all work on the device, traced runs
    kernel_s: Optional[float] = None           # the kernel launches alone, traced runs
    dtype: str = "float32"


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seed's parameters on the device: one uniform and one normal draw
    for all of them, cut and scaled by the reference's shapes and inits."""
    shapes = ref_smin.param_shapes(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 2654435761 + 97) % (2 ** 63))
    n_u = sum(torch.Size(s).numel() for s, kind, _ in shapes.values() if kind == "uniform")
    n_n = sum(torch.Size(s).numel() for s, kind, _ in shapes.values() if kind == "normal")
    uni = torch.rand(n_u, generator=gen, device=device) * 2 - 1
    nor = torch.randn(max(n_n, 1), generator=gen, device=device)
    out, ku, kn = {}, 0, 0
    for name, (shape, kind, scale) in shapes.items():
        n = torch.Size(shape).numel()
        if kind == "uniform":
            out[name] = (uni[ku:ku + n] * scale).reshape(shape)
            ku += n
        else:
            out[name] = (nor[kn:kn + n] * scale).reshape(shape)
            kn += n
    return out


def card_facts(device) -> Dict[str, str]:
    """The card's name and power limit, as nvidia-smi reads them."""
    if device.type != "cuda":
        return {"kind": "cpu", "power_limit": "none"}
    facts = {"kind": torch.cuda.get_device_name(device), "power_limit": "not read"}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", str(device.index or 0)], capture_output=True, text=True,
                             timeout=20)
        if out.returncode == 0 and out.stdout.strip():
            facts["power_limit"] = out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return facts


def metric_entry(m: Dict, value: float, facts: Dict[str, str], dtype: str) -> Dict:
    entry = {"value": value, "unit": m["unit"]}
    for k in ("layer", "moves", "workloads"):
        if k in m:
            entry[k] = m[k]
    if m["unit"] == "%" and ("mfu" in m["name"] or "roofline" in m["name"]):
        entry["peak"] = counts.PEAK_NAMES[dtype]
        entry["power_limit"] = facts["power_limit"]
    return entry


def run(root: str, cell_name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, after_check=None) -> Dict:
    """One run of ``cell_name``; returns the result line's object.
    ``after_check(ctx, driver, state, record, readings)``, where given, runs
    once the reference has judged the window (the calibration's control)."""
    device = torch.device(device)
    cell = spec.load_cell(root, cell_name)
    driver = spec.load_module(root, "drivers", cell.workload["driver"])
    t_enter = time.time()
    ctx = Context(cell, seed, device, cell.config, make_weights(cell.config, seed, device),
                  seconds)
    t_weights = time.time()
    state = driver.setup(ctx)
    gc.collect()
    gc.freeze()
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"set-up loaded JAX or the JAX package: {', '.join(found)}")
    setup_s = time.time() - t_start
    print(f"set-up {setup_s:.3f} s: start to the harness {t_enter - t_start:.3f} s, weights "
          f"{t_weights - t_enter:.3f} s, the driver's set-up {time.time() - t_weights:.3f} s",
          file=sys.stderr)

    tracer = Tracer(device=trace and device.type == "cuda")
    with tracer.window():
        with tracer.span("window"):
            record = driver.window(ctx, state, seconds, tracer)
    gc.unfreeze()
    record.spans = tracer.spans
    record.busy_s = tracer.busy_s()
    record.kernel_s = tracer.kernel_s()
    record.dtype = ctx.dtype
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    readings = driver.check(ctx, state, record)
    if after_check is not None:
        after_check(ctx, driver, state, record, readings)
    del state
    result_checks = checks.judge(readings, ctx.workload["check"]["limits"])
    facts = card_facts(device)

    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else record.e2e.get(m["name"])
            if value is not None:
                metrics[m["name"]] = metric_entry(m, value, facts, ctx.dtype)
    else:
        for m in cell.per_layer:
            value = spec.load_module(root, "metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = metric_entry(m, value, facts, ctx.dtype)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": facts["kind"],
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": checks.passed(result_checks) and record.failed == 0
           and record.attempted > 0,
           "attempted": record.attempted, "failed": record.failed, "metrics": metrics,
           "device": dev}
    if trace and record.busy_s is not None:
        dev["busy_s"] = record.busy_s
        dev["window_s"] = record.window_s
        out["breakdown"] = tracer.breakdown()
    out["checks"] = result_checks
    return out


def emit(result: Dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
