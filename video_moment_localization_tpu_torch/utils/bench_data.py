"""Input-pipeline benchmark of the PyTorch port (the JAX package's
``scripts/bench_data.py``, itself the reference's dataset.py ``__main__``
analog): one full train epoch a dataset through `BatchLoader`, the batch
shapes checked, the sample count and the wall time printed.

    python -m video_moment_localization_tpu_torch.utils.bench_data \
        [--data_root data] [--batch_size 64] [--num_workers 4]

Each dataset under ``--data_root`` (``charades``, ``activitynet``, ``tacos``,
laid out as ``scripts/prepare_data.sh`` writes them) is benchmarked where it
exists; the HDF5 datasets (ActivityNet, TACoS) are skipped with a message
where ``h5py`` is not installed. Without any, a synthetic Charades-style
directory (`data.synthetic.write_charades_style_dir`) in a temporary
directory is benchmarked, so the run always measures something. Host only:
no device is touched.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import tempfile
import time
from typing import Optional, Sequence

from video_moment_localization_tpu_torch.data.datasets import ActivityNet, CharadesSTA, TACoS
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.data.pipeline import BatchLoader

SPECS = (("CharadesSTA", CharadesSTA, "charades", dict(T=64, L=16, max_query_length=13)),
         ("ActivityNet", ActivityNet, "activitynet", dict(T=128, L=64, max_query_length=20)),
         ("TACoS", TACoS, "tacos", dict(T=128, L=32, max_query_length=14)))


def bench(name: str, dataset, batch_size: int, num_workers: int) -> dict:
    """One shuffled train epoch of ``dataset``; its samples, seconds and
    samples/s, printed."""
    loader = BatchLoader(dataset, batch_size, shuffle=True, num_workers=num_workers, seed=0)
    t0 = time.perf_counter()
    count = 0
    for batch in loader.epoch(0):
        assert batch["video_features"].shape[1] == dataset.T
        assert batch["query_features"].shape[1] == dataset.max_query_length
        count += int(batch["sample_mask"].sum())
    dt = time.perf_counter() - t0
    print(f"# of training samples in {name}: {count}")
    print(f"Total elapsed time ({dt:.5f}sec)  [{count / max(dt, 1e-9):.0f} samples/s]")
    return dict(name=name, samples=count, seconds=dt, samples_per_s=count / max(dt, 1e-9))


def main(argv: Optional[Sequence[str]] = None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--data_root", default="data")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--num_workers", type=int, default=4)
    args = parser.parse_args(argv)

    results, glove = [], None
    have_h5py = importlib.util.find_spec("h5py") is not None
    for name, cls, sub, kw in SPECS:
        data_dir = os.path.join(args.data_root, sub)
        probe = (os.path.join(data_dir, "annotations") if cls is CharadesSTA
                 else os.path.join(data_dir, "train.json"))
        if not os.path.exists(probe):
            print(f"{name}: no data at {data_dir}, skipping")
            continue
        if cls is not CharadesSTA and not have_h5py:
            print(f"{name}: h5py is not installed, skipping its HDF5 features at {data_dir}")
            continue
        glove = glove or WordEmbedding.load()
        results.append(bench(name, cls(data_dir, split="train", embedding=glove, **kw),
                             args.batch_size, args.num_workers))

    if not results:
        print("No real datasets found — benchmarking a synthetic Charades-style dir.")
        from video_moment_localization_tpu_torch.data.synthetic import write_charades_style_dir

        with tempfile.TemporaryDirectory() as tmp:
            root = write_charades_style_dir(tmp, num_videos=64, queries_per_video=4)
            emb = WordEmbedding.load(os.path.join(root, "glove/glove.6B.300d.txt"))
            ds = CharadesSTA(root, split="train", embedding=emb, **SPECS[0][3])
            results.append(bench("CharadesSTA(synthetic)", ds, args.batch_size,
                                 args.num_workers))
    return results


if __name__ == "__main__":
    main()
