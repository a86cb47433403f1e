"""Module-by-module smoke run of the PyTorch port (the JAX package's
``scripts/simpletest.py``, itself the reference's simpletest.py analog):
hermetic, on a synthetic batch, no downloads. Builds each block of the model
from seeded random weights, prints its output shapes, and checks that the
untrained sigmoid heads give probabilities near 0.5 inside the mask and 0
outside it.

    python -m video_moment_localization_tpu_torch.utils.simpletest \
        [--config_path config/charadessta.yml] [--device cuda|cpu]

Without ``--config_path`` a small config; ``--device`` defaults to the card.
The blocks are the plain dense units (`models.smin`); the whole forward is
`smin_forward` of the config's route, whose kernels run on the card.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from video_moment_localization_tpu_torch.config import ModelConfig, load_config
from video_moment_localization_tpu_torch.data.pipeline import BatchLoader
from video_moment_localization_tpu_torch.data.synthetic import SyntheticDataset
from video_moment_localization_tpu_torch.models.smin import (
    SMIN,
    backbone,
    boundary_unit,
    content_unit,
    localization,
    moment_unit,
    smi_block,
    smin_forward,
)
from video_moment_localization_tpu_torch.ops.cuda_build import resolve_device
from video_moment_localization_tpu_torch.ops.packing import unpack_map
from video_moment_localization_tpu_torch.ops.proposal import proposal_features

KEYS = ("video_features", "video_mask", "query_features", "query_mask", "length_mask",
        "moment_mask")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config_path", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = resolve_device(args.device, "simpletest")
    if args.config_path:
        cfg = load_config(args.config_path).model
    else:
        cfg = ModelConfig(T=32, L=8, C=4, D=64, dl=16, num_smi_layers=2, input_video_dim=24,
                          max_query_length=6, lstm_hidden_size=32)
    B = 4
    ds = SyntheticDataset(num_videos=B, queries_per_video=1, T=cfg.T, L=cfg.L,
                          max_query_length=cfg.max_query_length,
                          input_video_dim=cfg.input_video_dim, seed=0)
    batch = next(iter(BatchLoader(ds, B, num_workers=1, seed=0).epoch(0)))
    a = {k: torch.from_numpy(batch[k]).to(device) for k in KEYS}
    torch.manual_seed(0)
    model = SMIN(cfg).to(device).eval()
    shapes = {}

    with torch.no_grad():
        f, fs, fw = backbone(model.backbone, cfg, a["video_features"], a["video_mask"],
                             a["query_features"], a["query_mask"], fused_lstm=False)
        print(f"Backbone:            f {tuple(f.shape)}  fs {tuple(fs.shape)}  "
              f"fw {tuple(fw.shape)}")
        fc, fm, fb = proposal_features(f, a["moment_mask"], cfg.L, cfg.C)
        print(f"ProposalGeneration:  fc {tuple(fc.shape)}  fm {tuple(fm.shape)}  "
              f"fb {tuple(fb.shape)}")
        b0 = model.smis[0]
        qm, lm, mm = a["query_mask"], a["length_mask"], a["moment_mask"]
        shapes["content"] = content_unit(b0.content_unit, fc, fw, fs, fm, qm, mm).shape
        print(f"ContentUnit:         {tuple(shapes['content'])}")
        shapes["boundary"] = boundary_unit(b0.boundary_unit, fb, fw, fs, fm, qm, lm).shape
        print(f"BoundaryUnit:        {tuple(shapes['boundary'])}")
        cu = content_unit(b0.content_unit, fc, fw, fs, fm, qm, mm)
        bu = boundary_unit(b0.boundary_unit, fb, fw, fs, fm, qm, lm)
        shapes["moment"] = moment_unit(b0.moment_unit, cu, fm, bu, mm).shape
        print(f"MomentUnit:          {tuple(shapes['moment'])}")
        fc2, fm2, fb2 = smi_block(b0, fc, fm, fb, fw, fs, qm, lm, mm)
        print(f"SMI block:           fc {tuple(fc2.shape)}  fm {tuple(fm2.shape)}  "
              f"fb {tuple(fb2.shape)}")
        pm, ps, pe, pa = localization(model.localization, fm2, fb2, lm, mm)
        print(f"Localization:        pm {tuple(pm.shape)}  ps {tuple(ps.shape)}  "
              f"pe {tuple(pe.shape)}  pa {tuple(pa.shape)}")
        pm, ps, pe, pa = smin_forward(model, cfg, *(a[k] for k in KEYS))
    if pm.dim() == 2:      # the packed head: densified for the inspection below
        pm = unpack_map(pm, cfg.L)
    pm, ps = pm.cpu().numpy(), ps.cpu().numpy()
    valid, lvalid = a["moment_mask"].cpu().numpy() > 0, a["length_mask"].cpu().numpy() > 0
    mean_pm, mean_ps = float(pm[valid].mean()), float(ps[lvalid].mean())
    print(f"SMIN forward:        pm {pm.shape}, masked means pm={mean_pm:.3f} ps={mean_ps:.3f} "
          f"(untrained heads should sit near 0.5)")
    assert 0.2 < mean_pm < 0.8 and 0.2 < mean_ps < 0.8, "untrained heads look off"
    assert np.all(pm[~valid] == 0), "masked moments must score 0"
    print("OK")
    return dict(shapes={k: tuple(v) for k, v in shapes.items()}, pm_shape=pm.shape,
                mean_pm=mean_pm, mean_ps=mean_ps)


if __name__ == "__main__":
    main()
