"""Every run decides ``correct`` by the reference: with the timed path
broken underneath, a whole run (the chip look skipped, on the CPU at a tiny
size) comes out not correct, once for each fault the cells can have. The
cells have one chip each, so no exchange between chips can be left out."""

import time

import pytest
import torch

from h100_bench.lib import harness

from video_moment_localization_tpu_torch import inference
from video_moment_localization_tpu_torch.parallel import steps


def run(root, cell, seed=2 ** 31 + 77):
    return harness.run(root, cell, seed, 0.4, False, "cpu", time.time())


@pytest.mark.parametrize("cell", ["anet.train", "charades.serve.grouped"])
def test_sound_runs_are_correct(tiny, cell):
    out = run(tiny, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_a_step_that_leaves_the_state_unchanged(tiny, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    assert not run(tiny, "anet.train")["correct"]


def test_half_the_batch_left_out(tiny, monkeypatch):
    real = steps.smin_loss

    def half(outputs, batch, denominator=None):
        mask = batch.get("sample_mask", torch.ones(batch["length_mask"].shape[0]))
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = 0.0
        return real(outputs, dict(batch, sample_mask=mask), denominator)

    monkeypatch.setattr(steps, "smin_loss", half)
    assert not run(tiny, "anet.train")["correct"]


@pytest.mark.parametrize("how", ["score", "moment"])
def test_an_answer_altered_where_it_is_produced(tiny, monkeypatch, how):
    real = inference.MomentLocalizer.collect

    def altered(self, handle):
        out = real(self, handle)
        for answer in out:
            m = answer[0]
            if how == "score":
                answer[0] = inference.Moment(m.start, m.end, m.score * 0.9)
            else:
                answer[0] = inference.Moment(m.start, m.end + (m.end - m.start), m.score)
        return out

    monkeypatch.setattr(inference.MomentLocalizer, "collect", altered)
    assert not run(tiny, "charades.serve.grouped")["correct"]

