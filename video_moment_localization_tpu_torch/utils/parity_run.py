"""The PyTorch port's side of the dual-train accuracy-parity run (the JAX
package's ``scripts/parity_run.py``): train the port on the same on-disk
Charades-style fixture from the same initial weights as the JAX ``ours`` run,
write the reference ``stats.json`` schema, and report the two runs side by
side.

    python -m video_moment_localization_tpu_torch.utils.parity_run SUBCOMMAND ...

Subcommands:
    gen          write the learnable synthetic fixture and its ``parity.yml``
                 (the same files as the JAX script's ``gen``: the port's
                 synthetic writer draws the same bytes)
    export-init  the port's seeded initial weights in the reference layout
                 (``{"epoch": 0, "model": state_dict}``); the JAX script's
                 ``export-init`` writes the same format from its own seed
    ours         epoch-0 eval, then train the port on the fixture from
                 ``--init`` (a reference-layout ``init.pt``, loaded strictly):
                 ``init_eval.json``, ``{experiment}_stats.json``,
                 ``wallclock.json`` in ``--out-dir``
    report       compare the port's run with the JAX ``ours`` run's stats
                 (markdown to stdout, or ``--out``)

The JAX script's ``ref`` subcommand trains the reference checkout, which
this environment does not have, so it has no counterpart here: the port is
held to the JAX run instead. ``ours`` runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional, Sequence

CONFIG_TEMPLATE = """\
# Shared parity-run config (reference-compatible 20-key schema).
dataset:            "charadessta"
data_dir:           "{data_dir}"
T:                  {T}
L:                  {L}
C:                  4
model:              "SMIN"
d:                  512
dl:                 128
input_video_dim:    {input_video_dim}
max_query_length:   {max_query_length}
lstm_hidden_size:   256
num_smi_layers:     {num_smi_layers}
optimizer:          "Adam"
lr:                 0.0005
num_epochs:         {num_epochs}
batch_size:         {batch_size}
num_workers:        {num_workers}
seed:               {seed}
checkpoint_path:    "{checkpoint_path}"
resume_training:    {resume}
"""

# The JAX script's model-geometry presets: the flagship Charades-STA shape,
# and the ActivityNet geometry (L=64: the content-unit train route).
PRESETS = {
    "charades": dict(T=64, L=16, input_video_dim=1024, max_query_length=13, batch_size=64),
    "anet": dict(T=128, L=64, input_video_dim=500, max_query_length=20, batch_size=16),
}
METRICS = [f"R@{n}, IoU={m}" for n in (1, 5) for m in (0.1, 0.3, 0.5, 0.7)]


def cmd_gen(args) -> str:
    from video_moment_localization_tpu_torch.data.synthetic import write_charades_style_dir

    preset = PRESETS[args.preset]
    write_charades_style_dir(args.root, queries_per_video=args.queries,
                             input_video_dim=preset["input_video_dim"], seed=args.seed,
                             signal_strength=args.signal,
                             videos_per_split={"train": args.train_videos,
                                               "test": args.test_videos})
    cfg_path = os.path.join(args.root, "parity.yml")
    with open(cfg_path, "w") as f:
        f.write(CONFIG_TEMPLATE.format(
            data_dir=args.root, num_epochs=args.epochs, num_workers=0, seed=args.seed,
            num_smi_layers=args.smi_layers, checkpoint_path=os.path.join(args.root, "ckpt_ours"),
            resume="False", **preset))
    print(f"fixture: {args.train_videos}x{args.queries} train / {args.test_videos}x"
          f"{args.queries} test samples at {args.root}")
    print(f"config: {cfg_path}")
    return cfg_path


def cmd_export_init(args) -> None:
    import torch

    from video_moment_localization_tpu_torch.config import load_config
    from video_moment_localization_tpu_torch.models.smin import SMIN

    cfg = load_config(args.config)
    torch.manual_seed(cfg.seed)
    torch.save({"epoch": 0, "model": SMIN(cfg.model).state_dict()}, args.out)
    print(f"wrote seed-{cfg.seed} initial weights (reference layout) -> {args.out}")


def cmd_ours(args) -> dict:
    import dataclasses

    import torch

    from video_moment_localization_tpu_torch.config import load_config
    from video_moment_localization_tpu_torch.data.pipeline import BatchLoader
    from video_moment_localization_tpu_torch.train.trainer import Trainer, build_datasets

    cfg = load_config(args.config, num_epochs_override=args.epochs or 0)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, seed=args.seed)
    if args.out_dir:
        cfg.checkpoint_path = args.out_dir
    os.makedirs(cfg.checkpoint_path, exist_ok=True)
    # The same reference-layout weights on every run, both sides, every
    # seed: the seed then drives only the shuffle order and the sampling.
    state = torch.load(args.init, weights_only=False)["model"] if args.init else None
    trainer = Trainer(cfg, device=args.device, state_dict=state)
    if args.init:
        print(f"loaded shared initial weights from {args.init}")
    train_ds, eval_ds = build_datasets(cfg)
    print(f"port datasets: {len(train_ds)} train / {len(eval_ds)} eval")
    eval_loader = BatchLoader(eval_ds, cfg.batch_size, shuffle=False,
                              num_workers=cfg.num_workers, seed=cfg.seed)
    t0 = time.perf_counter()
    eval_loss, eval_metrics = trainer._run_epoch(eval_loader, 0, False)
    init_eval = {"eval_loss": eval_loss, **eval_metrics, "wall_s": time.perf_counter() - t0}
    with open(os.path.join(cfg.checkpoint_path, "init_eval.json"), "w") as f:
        json.dump(init_eval, f, indent=1)
    print(f"init eval: loss={eval_loss:.6f} ({init_eval['wall_s']:.0f}s)")
    if cfg.num_epochs > 0:
        train_loader = BatchLoader(train_ds, cfg.batch_size, shuffle=True,
                                   num_workers=cfg.num_workers, seed=cfg.seed)
        t0 = time.perf_counter()
        trainer.fit(train_loader, eval_loader)
        wall = time.perf_counter() - t0
        n_pairs = cfg.num_epochs * (len(train_ds) + len(eval_ds))
        with open(os.path.join(cfg.checkpoint_path, "wallclock.json"), "w") as f:
            json.dump({"wall_s": wall, "epochs": cfg.num_epochs, "train_samples": len(train_ds),
                       "eval_samples": len(eval_ds), "samples_per_s": n_pairs / wall,
                       "device": str(trainer.device)}, f, indent=1)
        print(f"port training done in {wall:.0f}s")
    return init_eval


def _load(ckpt_dir: str, experiment: str):
    """(stats, init_eval or None) of a run's output directory."""
    with open(os.path.join(ckpt_dir, f"{experiment}_stats.json")) as f:
        stats = json.load(f)
    init_path = os.path.join(ckpt_dir, "init_eval.json")
    init = None
    if os.path.exists(init_path):
        with open(init_path) as f:
            init = json.load(f)
    return stats, init


def report(jax_dirs: Sequence[str], port_dirs: Sequence[str], experiment: str = "parity"
           ) -> List[str]:
    """The markdown lines that compare the port's runs (``port_dirs``) with
    the JAX ``ours`` runs (``jax_dirs``): the epoch-0 eval from the shared
    weights (the tight check), the train / eval loss trajectories, and the
    final-epoch metrics with the gap of the means and each side's seed
    spread."""
    jax_runs = [_load(d, experiment) for d in jax_dirs]
    port_runs = [_load(d, experiment) for d in port_dirs]
    lines = ["# Parity: the PyTorch port against the JAX package", ""]
    w = lines.append
    jinit, pinit = jax_runs[0][1], port_runs[0][1]
    if jinit and pinit:
        w("## Epoch-0 eval from shared weights")
        w("")
        w("| quantity | JAX | port | abs diff |")
        w("|---|---|---|---|")
        for k in ["eval_loss"] + METRICS:
            if k in jinit and k in pinit:
                w(f"| {k} | {jinit[k]:.6f} | {pinit[k]:.6f} | {abs(jinit[k] - pinit[k]):.2e} |")
        w("")
    stats = [s for s, _ in jax_runs] + [s for s, _ in port_runs]
    head = ("".join(f" JAX s{j + 1} |" for j in range(len(jax_runs)))
            + "".join(f" port s{j + 1} |" for j in range(len(port_runs))))
    w("## Training trajectories")
    w("")
    w(f"| epoch | train_loss:{head} eval_loss:{head}")
    w("|---" * (1 + 2 * len(stats)) + "|")
    for i, ep in enumerate(stats[0]["epoch"]):
        tl = "".join(f" {s['train_loss'][i]:.4f} |" for s in stats)
        el = "".join(f" {s['eval_loss'][i]:.4f} |" if i < len(s.get("eval_loss", []))
                     else " - |" for s in stats)
        w(f"| {ep} |{tl}{el}")
    w("")
    w("## Final-epoch eval metrics")
    w("")
    w(f"| metric |{head} port-JAX (means) | JAX spread | port spread |")
    w("|---" * (4 + len(stats)) + "|")
    worst = 0.0
    for k in METRICS:
        js = [s[f"eval_{k}"][-1] for s, _ in jax_runs]
        ps = [s[f"eval_{k}"][-1] for s, _ in port_runs]
        gap = sum(ps) / len(ps) - sum(js) / len(js)
        worst = max(worst, abs(gap))
        cells = "".join(f" {v:.4f} |" for v in js + ps)
        w(f"| {k} |{cells} {gap:+.4f} | {max(js) - min(js):.4f} | {max(ps) - min(ps):.4f} |")
    w("")
    w(f"Largest |mean(port) - mean(JAX)| gap: **{worst:.4f}** (recall fractions in [0, 1]).")
    return lines


def cmd_report(args) -> List[str]:
    lines = report(args.jax_dirs, args.port_dirs, args.experiment)
    text = "\n".join(lines) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        print(text, end="")
    return lines


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen")
    g.add_argument("--root", required=True)
    g.add_argument("--preset", choices=sorted(PRESETS), default="charades")
    g.add_argument("--train-videos", type=int, default=250)
    g.add_argument("--test-videos", type=int, default=50)
    g.add_argument("--queries", type=int, default=8)
    g.add_argument("--signal", type=float, default=1.2)
    g.add_argument("--seed", type=int, default=43)
    g.add_argument("--epochs", type=int, default=10)
    g.add_argument("--smi-layers", type=int, default=3)
    g.set_defaults(fn=cmd_gen)

    e = sub.add_parser("export-init")
    e.add_argument("--config", required=True)
    e.add_argument("--out", required=True)
    e.set_defaults(fn=cmd_export_init)

    o = sub.add_parser("ours")
    o.add_argument("--config", required=True)
    o.add_argument("--out-dir", default=None)
    o.add_argument("--epochs", type=int, default=None)
    o.add_argument("--seed", type=int, default=None)
    o.add_argument("--init", default=None)
    o.add_argument("--device", default="cuda")
    o.set_defaults(fn=cmd_ours)

    r = sub.add_parser("report")
    r.add_argument("--jax-dirs", nargs="+", required=True)
    r.add_argument("--port-dirs", nargs="+", required=True)
    r.add_argument("--experiment", default="parity")
    r.add_argument("--out", default=None)
    r.set_defaults(fn=cmd_report)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
