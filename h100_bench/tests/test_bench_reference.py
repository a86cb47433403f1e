"""The plain reference against the port at tiny sizes on the CPU, where the
port runs its kernels' plain versions: the featurization, the forward, the
loss and its gradient, Adam and the label generators."""

import numpy as np
import pytest
import torch

import tiny
from h100_bench.lib import harness, program, traffic
from h100_bench.reference import featurize, labels, smin as ref_smin, train as ref_train

from video_moment_localization_tpu_torch.data import labels as port_labels
from video_moment_localization_tpu_torch.data.glove import WordEmbedding
from video_moment_localization_tpu_torch.inference import MomentLocalizer
from video_moment_localization_tpu_torch.models.smin import smin_forward, smin_forward_inference
from video_moment_localization_tpu_torch.train.loss import smin_loss

DEV = torch.device("cpu")


def config(**over):
    base = tiny.load(tiny.os.path.join(tiny.BENCH, "configs", "activitynet.json"))
    base.update(tiny.TINY)
    base.update(over)
    return base


def serving_inputs(cfg, n, seed):
    tr = {"vocab": cfg["vocab_size"], "videos": {"pool": n, "clips": [1, 3 * cfg["T"]]},
          "duration_s": [10.0, 60.0], "query_words": [1, cfg["max_query_length"] + 2]}
    pool = traffic.serving_pool(tr, cfg, seed, DEV)
    qs = traffic.queries(n, tuple(tr["query_words"]), pool["words"], pool["rng"])
    return pool, [(v, q, float(d)) for v, q, d in zip(pool["videos"], qs, pool["durations"])]


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_featurization_matches_the_localizer(seed):
    cfg = config()
    pool, reqs = serving_inputs(cfg, 12, seed)
    conf = program.config(cfg)
    loc = MomentLocalizer(conf.model, program.model(conf, harness.make_weights(cfg, seed, DEV), DEV),
                          program.embedding(pool["words"], pool["vectors"]), device="cpu")
    ours = featurize.featurize(reqs, {w: i for i, w in enumerate(pool["words"])}, pool["vectors"],
                               cfg["T"], cfg["L"], cfg["max_query_length"])
    for r, row in enumerate(reqs):
        vf, vm, lm, _ = loc._prepare_video(row[0])
        qf, qm = loc._prepare_query(row[1])
        np.testing.assert_array_equal(ours["video_features"][r], vf)
        np.testing.assert_array_equal(ours["video_mask"][r], vm)
        np.testing.assert_array_equal(ours["length_mask"][r], lm)
        np.testing.assert_array_equal(ours["query_features"][r], qf)
        np.testing.assert_array_equal(ours["query_mask"][r], qm)


@pytest.mark.parametrize("layers,seed", [(1, 3), (2, 11), (3, 2 ** 32 + 5)])
def test_forward_matches_the_port(layers, seed):
    cfg = config(num_smi_layers=layers)
    weights = harness.make_weights(cfg, seed, DEV)
    conf = program.config(cfg)
    net = program.model(conf, weights, DEV)
    pool, reqs = serving_inputs(cfg, 10, seed)
    x = featurize.featurize(reqs, {w: i for i, w in enumerate(pool["words"])}, pool["vectors"],
                            cfg["T"], cfg["L"], cfg["max_query_length"])
    x = {k: torch.from_numpy(v) for k, v in x.items()}
    keys = ("video_features", "video_mask", "query_features", "query_mask", "length_mask")
    port = smin_forward_inference(net, conf.model, *(x[k] for k in keys))
    with torch.no_grad():
        ref = ref_smin.forward(weights, cfg, *(x[k] for k in keys))
    for a, b in zip(port, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(0)
    p0 = torch.randn(5, 7, generator=g)
    grads = [torch.randn(5, 7, generator=g) for _ in range(3)]
    p = p0.clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=5e-4, betas=(0.9, 0.999), eps=1e-8, foreach=False)
    q, m, v = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
    for t, gr in enumerate(grads, start=1):
        p.grad = gr.clone()
        opt.step()
        ref_train.adam_update(q, gr, m, v, t, 5e-4)
    torch.testing.assert_close(p.detach(), q, rtol=0, atol=1e-7)


def test_loss_and_gradient_match_the_port():
    cfg = config(num_smi_layers=2)
    weights = harness.make_weights(cfg, 5, DEV)
    batch = traffic.train_batches({"pool": 1, "batch": 6, "padded": 1, "duration_s": [5.0, 60.0]},
                                  cfg, 5, DEV)[0]
    conf = program.config(cfg)
    net = program.model(conf, weights, DEV)
    keys = ("video_features", "video_mask", "query_features", "query_mask", "length_mask")
    loss, _ = smin_loss(smin_forward(net, conf.model, *(batch[k] for k in keys)), batch)
    loss.backward()
    W = {k: v.clone().requires_grad_(True) for k, v in weights.items()}
    ref_loss = ref_train.loss_and_grad(W, cfg, batch, block=4)
    assert abs(float(loss.detach()) - ref_loss) <= 1e-5 * abs(ref_loss)
    params = dict(net.named_parameters())
    for name, w in W.items():
        torch.testing.assert_close(params[name].grad, w.grad, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("span", [(0.0, 5.0, 30.0), (3.1, 17.9, 20.0), (12.0, 13.0, 13.5)])
def test_labels_match_the_port(span):
    s, e, dur = span
    for L in (4, 16, 64):
        np.testing.assert_array_equal(labels.iou_map(s, e, dur, L),
                                      port_labels.iou_target_map(s, e, dur, L))
        for a, b in zip(labels.boundary_curves(s, e, dur, L),
                        port_labels.boundary_penalties(s, e, dur, L)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(labels.snippet_inside(s, e, dur, L),
                                      port_labels.snippet_labels(s, e, dur, L))
        for n in (1, L // 2, 2 * L):
            vm, lm = labels.masks(min(n, 2 * L), 2 * L, L)
            pvm, plm, _ = port_labels.build_masks(min(n, 2 * L), 2 * L, L)
            np.testing.assert_array_equal(vm, pvm)
            np.testing.assert_array_equal(lm, plm)


def test_word_table_lookup_matches():
    words = ["a1x", "b2x", "c3x"]
    vecs = np.arange(9, dtype=np.float32).reshape(3, 3)
    emb = WordEmbedding(vecs, {w: i for i, w in enumerate(words)})
    for q in ("A1X b2x, zzz", "c3x", "b2x a1x c3x b2x a1x c3x b2x"):
        ids, qf = emb.encode(q.lower().replace(",", "").split(), 5)
        ours, mask = featurize.encode_query(q, {w: i for i, w in enumerate(words)}, vecs, 5)
        np.testing.assert_array_equal(ours, qf)
        np.testing.assert_array_equal(mask, emb.query_mask(ids))
