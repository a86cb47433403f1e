"""Data parallelism of the PyTorch port (parallel/mesh.py, the train step's
gradient reduction, the trainer and the CLI) on the CPU against the JAX
package's 2-device mesh.

Two gloo ranks, each a process that `parallel.mesh.spawn` starts (the
``spawn`` start method; the rank functions in tests/_torch_dp_workers.py
import no JAX), meet through a ``file://`` store in a temporary directory,
so no port is taken; every spawn is joined under its own timeout. From the
same weights (JAX parameters carried across by `state_dict_from_jax_params`)
and the same global batches (seeded NumPy, tests/_torch_train_common.py's
small widths), the JAX side runs `make_train_step` on `make_mesh(2)` with
`put_batch`:

* 3 steps: the global loss of step 1 within rtol 1e-5 and all three within
  2e-4, every gradient of step 1 after the reduction at GRAD_TOL (rtol 5e-4
  / atol 5e-5), as tests/test_torch_train_step.py holds one device; the
  first batch's shards hold 4 and 3 valid samples;
* a global batch whose shards hold 4 and 1 valid samples, and one whose
  second shard is empty (all rows zero and masked, as the loader emits it):
  loss and gradients the same way;
* the eval step's loss sum, valid count and recall counts summed over the
  ranks against the JAX eval step on the mesh;
* the parameters bit for bit equal across the ranks after every step;
* every parameter reduced on the whole-layer, content-unit, dense and compat
  routes, each step's gradient equal to one process's on the whole batch;
* `maybe_enable_remat` deciding as the JAX trainer's at its 6e9 budget;
* the CLI at ``--num_devices 2 --device cpu``: an epoch within 2e-4 of one
  process's, its artifacts written once, a 1 + 1 resume equal to the
  uninterrupted 2-rank run, ``--test`` printing its 8 metrics once.
"""

import contextlib
import functools
import io
import json
import os
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dp_workers
from _torch_train_common import (
    CFG,
    GRAD_TOL,
    JCFG,
    SHAPE,
    TINY_CFG,
    make_batch,
    make_model,
    to_torch,
)
from video_moment_localization_tpu.config import load_config as j_load_config
from video_moment_localization_tpu.models import smin_forward as j_smin_forward
from video_moment_localization_tpu.parallel import steps as jsteps
from video_moment_localization_tpu.parallel.mesh import make_mesh, put_batch, put_replicated
from video_moment_localization_tpu.train.loss import smin_loss as j_smin_loss
from video_moment_localization_tpu.train.trainer import Trainer as JTrainer
from video_moment_localization_tpu_torch.config import Config, ModelConfig, load_config
from video_moment_localization_tpu_torch.data.synthetic import write_charades_style_dir
from video_moment_localization_tpu_torch.main import main
from video_moment_localization_tpu_torch.models.port import state_dict_from_jax_params
from video_moment_localization_tpu_torch.parallel import mesh
from video_moment_localization_tpu_torch.parallel.steps import build_optimizer, make_train_step
from video_moment_localization_tpu_torch.train.trainer import maybe_enable_remat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 5e-4
TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for this module's tiny models (each spawned rank
    takes its own share): the test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
FORWARD_KEYS = ("video_features", "video_mask", "query_features", "query_mask", "length_mask",
                "moment_mask")
# The routes of the train forward (models/smin.py): a narrow map over the
# whole-layer rule's row cap takes the content-unit kernels.
ROUTES = {
    "content_unit": dict(T=32, L=32, C=9, D=16, dl=8, num_smi_layers=2, input_video_dim=6,
                         max_query_length=4, lstm_hidden_size=8),
    "dense": dict(SHAPE, packed=False),
    "compat": dict(SHAPE, compat_head=True, fused_content=True),
}


def padded(batch, valid):
    """``batch`` with only its first ``valid`` rows real: the others zero and
    masked, as the loader pads a partial batch and emits an empty shard."""
    out = {k: v.copy() for k, v in batch.items()}
    for v in out.values():
        v[valid:] = 0
    return out


def spawn_cases(tmp_path, cases):
    """`_torch_dp_workers.run_cases` on two gloo ranks on the CPU; returns
    each rank's results."""
    pattern = str(tmp_path / "rank%d.pt")
    mesh.spawn(_torch_dp_workers.run_cases, 2, ["cpu", "cpu"], "gloo", args=(cases, pattern),
               timeout_s=TIMEOUT_S)
    return [torch.load(pattern % r, weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """One spawn of two ranks over every case; the JAX params and batches."""
    params, model = make_model(31)
    state = model.state_dict()
    steps = [make_batch(B=8, seed=40 + k) for k in range(3)]
    tail = padded(make_batch(B=8, seed=50), 5)    # shards of 4 and 1 valid samples
    empty = padded(make_batch(B=4, seed=51), 2)   # the second shard empty
    cases = [dict(name="steps", model=SHAPE, state=state, batches=steps, lr=LR, eval=True),
             dict(name="tail", model=SHAPE, state=state, batches=[tail], lr=LR),
             dict(name="empty", model=SHAPE, state=state, batches=[empty], lr=LR)]
    routes = {}
    for k, (name, shape) in enumerate(ROUTES.items()):
        cfg = ModelConfig(**shape)
        _, rmodel = make_model(60 + k, shape)
        batch = make_batch(B=4, seed=70 + k, cfg=cfg, packed_labels=cfg.packed and
                           not cfg.compat_head)
        routes[name] = (cfg, rmodel.state_dict(), batch)
        cases.append(dict(name=name, model=shape, state=rmodel.state_dict(), batches=[batch],
                          lr=LR))
    ranks = spawn_cases(tmp_path_factory.mktemp("dp"), cases)
    return types.SimpleNamespace(params=params, steps=steps, tail=tail, empty=empty,
                                 ranks=ranks, routes=routes)


def jax_loss_and_grads(params, batch, mesh2):
    """The global batch's loss and gradients on the 2-device mesh, under the
    port's parameter names."""
    def jloss(p, b):
        return j_smin_loss(j_smin_forward(p, JCFG, *(b.get(k) for k in FORWARD_KEYS)), b)[0]

    loss, g = jax.jit(jax.value_and_grad(jloss))(put_replicated(params, mesh2),
                                                  put_batch(batch, mesh2))
    return float(loss), state_dict_from_jax_params(jax.tree.map(np.asarray, g))


def assert_grads(got, want):
    assert set(got) == set(want)
    for name, g in got.items():
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), **GRAD_TOL, err_msg=name)


def test_three_steps_match_the_jax_mesh(dp):
    mesh2 = make_mesh(2)
    jopt = optax.adam(LR)
    jstep = jsteps.make_train_step(JCFG, jopt)
    jparams = put_replicated(jax.tree.map(jnp.asarray, dp.params), mesh2)
    state = put_replicated(jopt.init(jparams), mesh2)
    want = []
    for b in dp.steps:
        jparams, state, metrics = jstep(jparams, state, put_batch(b, mesh2))
        want.append(float(metrics["loss"]))
    got = dp.ranks[0]["steps"]["loss"]
    assert dp.ranks[1]["steps"]["loss"] == got
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4)
    loss, grads = jax_loss_and_grads(dp.params, dp.steps[0], mesh2)
    np.testing.assert_allclose(got[0], loss, rtol=1e-5)
    assert_grads(dp.ranks[0]["steps"]["grads"], grads)


@pytest.mark.parametrize("case", ["tail", "empty"])
def test_uneven_shards_take_the_global_batch_gradient(dp, case):
    """Shards with 4 and 1, or 2 and 0, valid samples: the gradient of the
    global batch's mean loss, not the mean of the shards' means."""
    batch = getattr(dp, case)
    b = len(batch["sample_mask"]) // 2
    assert batch["sample_mask"][:b].sum() != batch["sample_mask"][b:].sum()
    loss, grads = jax_loss_and_grads(dp.params, batch, make_mesh(2))
    got = dp.ranks[0][case]
    np.testing.assert_allclose(got["loss"][0], loss, rtol=1e-5)
    assert_grads(got["grads"], grads)
    for name, g in got["grads"].items():
        assert torch.equal(g, dp.ranks[1][case]["grads"][name]), name


def test_eval_step_sums_match_the_jax_mesh(dp):
    mesh2 = make_mesh(2)
    params = put_replicated(jax.tree.map(jnp.asarray, dp.params), mesh2)
    want = jsteps.make_eval_step(JCFG)(params, put_batch(dp.steps[0], mesh2))
    for r in range(2):
        sums = dp.ranks[r]["steps"]["eval"].numpy()
        assert sums[1] == dp.steps[0]["sample_mask"].sum() == 7
        np.testing.assert_allclose(sums[0] / sums[1], float(want["loss"]), rtol=1e-5)
        np.testing.assert_array_equal(sums[2:].reshape(2, 4), np.asarray(want["counts"]))


def test_parameters_equal_across_ranks_after_every_step(dp):
    for case in ("steps", "tail", "empty", *ROUTES):
        a, b = dp.ranks[0][case]["params"], dp.ranks[1][case]["params"]
        assert len(a) == len(dp.ranks[0][case]["loss"])
        for step_a, step_b in zip(a, b):
            for name, p in step_a.items():
                assert torch.equal(p, step_b[name]), (case, name)


@pytest.mark.parametrize("route", ["whole_layer", *ROUTES])
def test_every_parameter_is_reduced_on_every_route(dp, route):
    """Each route gives every parameter a gradient (none left unreduced),
    and the two ranks' summed gradient is one process's on the whole batch."""
    if route == "whole_layer":
        cfg, state, batch, got = CFG, None, dp.steps[0], dp.ranks[0]["steps"]
        _, model = make_model(31)
    else:
        cfg, state, batch = dp.routes[route]
        got = dp.ranks[0][route]
        model = make_model(0, ROUTES[route])[1]
        model.load_state_dict(state)
    step = make_train_step(cfg, model, build_optimizer(Config(model=cfg, lr=LR), model),
                           device="cpu")
    step(to_torch(batch))
    named = dict(model.named_parameters())
    assert set(got["grads"]) == set(named)
    for name, p in named.items():
        np.testing.assert_allclose(got["grads"][name].numpy(), p.grad.numpy(), **GRAD_TOL,
                                   err_msg=name)


def test_a_missing_gradient_is_refused_not_skipped():
    model = torch.nn.Linear(2, 2)
    model.weight.grad = torch.zeros(2, 2)
    with pytest.raises(RuntimeError, match="parameter bias has no gradient"):
        mesh.all_reduce_gradients(model.named_parameters(), None)


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("name", ["charadessta", "tacos", "activitynet"])
def test_remat_decision_matches_the_jax_trainer(name, world):
    path = os.path.join(REPO, "config", f"{name}.yml")
    cfg = load_config(path)
    jcfg = j_load_config(path)
    fake = types.SimpleNamespace(cfg=jcfg, mesh=types.SimpleNamespace(size=world))
    JTrainer._maybe_enable_remat(fake)
    got = maybe_enable_remat(cfg.model, cfg.batch_size, world, 6e9, verbose=False)
    assert got.remat_smi == fake.cfg.model.remat_smi
    assert got.remat_smi == (name == "activitynet")


def test_initialize_distributed_names_what_a_launcher_sets(monkeypatch):
    for var in mesh.LAUNCHER_VARIABLES:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT not set"):
        mesh.initialize_distributed(device="cpu")
    assert (mesh.rank(), mesh.world_size(), mesh.default_group()) == (0, 1, None)


def test_a_failing_rank_fails_the_spawn():
    """A rank that raises makes the spawn raise with that rank's traceback,
    the rank that waits for it terminated."""
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        mesh.spawn(_torch_dp_workers.fail_or_wait, 2, ["cpu", "cpu"], "gloo", args=(1, 600),
                   timeout_s=TIMEOUT_S)


def test_a_hanging_rank_times_out():
    with pytest.raises(TimeoutError, match="ranks still running after 1 s"):
        mesh.spawn(_torch_dp_workers.fail_or_wait, 2, ["cpu", "cpu"], "gloo",
                   args=(-1, 600), timeout_s=1)


# --------------------------------------------------------------------- #
# The CLI at two ranks
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    """A Charades-style directory whose splits end in a global batch of 2
    (B=4): the second rank's shard of it is empty."""
    root = tmp_path_factory.mktemp("dp_cli")
    write_charades_style_dir(str(root / "data"), queries_per_video=2,
                             videos_per_split={"train": 5, "test": 3})
    return root


def cli_cfg(root, name, resume=False):
    path = root / f"{name}.yml"
    path.write_text(TINY_CFG.format(ckpt=str(root / name), data=str(root / "data"),
                                    resume=resume) + "batch_size: 4\n")
    return str(path)


def stats_of(root, name):
    with open(root / name / f"{name}_stats.json") as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def cli_runs(cli_dir):
    """Two epochs at two ranks ("whole"), one epoch and a resume to two
    ("cut"), one process's epoch ("single") and ``--test`` at two ranks,
    with their stdout."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        mp.setattr(mesh, "spawn", functools.partial(mesh.spawn, timeout_s=TIMEOUT_S))
        for name, argv in (
                ("whole", ["--config_path", cli_cfg(cli_dir, "whole"), "--num_epochs", "2",
                           "--num_devices", "2"]),
                ("single", ["--config_path", cli_cfg(cli_dir, "single"), "--num_epochs", "1"]),
                ("cut1", ["--config_path", cli_cfg(cli_dir, "cut"), "--num_epochs", "1",
                          "--num_devices", "2"]),
                ("cut2", ["--config_path", cli_cfg(cli_dir, "cut", resume=True),
                          "--num_epochs", "2", "--num_devices", "2"]),
                ("test", ["--config_path", cli_cfg(cli_dir, "whole"), "--test",
                          "--num_devices", "2"])):
            out[name] = fd_stdout(lambda: main([*argv, "--device", "cpu"]))
    finally:
        mp.undo()
    return out


def fd_stdout(fn):
    """What ``fn()`` prints and what the processes it starts write to file
    descriptor 1."""
    buf = io.StringIO()
    with tempfile.TemporaryFile(mode="w+") as tmp:
        saved = os.dup(1)
        os.dup2(tmp.fileno(), 1)
        try:
            with contextlib.redirect_stdout(buf):
                fn()
        finally:
            os.dup2(saved, 1)
            os.close(saved)
        tmp.seek(0)
        return buf.getvalue() + tmp.read()


def test_cli_two_ranks_match_one_process(cli_dir, cli_runs):
    whole, single = stats_of(cli_dir, "whole"), stats_of(cli_dir, "single")
    assert whole["epoch"] == [1, 2] and single["epoch"] == [1]
    for key, vals in single.items():
        np.testing.assert_allclose(whole[key][0], vals[0], rtol=2e-4, atol=2e-4, err_msg=key)


def test_cli_two_ranks_write_once(cli_dir, cli_runs):
    out = cli_runs["whole"]
    assert out.count("Training Epoch - 1") == 1 and out.count("Training Epoch - 2") == 1
    assert out.count("throughput - ") == 2
    assert sorted(os.listdir(cli_dir / "whole")) == ["whole_model.ckpt", "whole_stats.json"]
    ckpt = torch.load(cli_dir / "whole" / "whole_model.ckpt", weights_only=True)
    assert ckpt["epoch"] == 2


def test_cli_two_ranks_resume_equals_the_uninterrupted_run(cli_dir, cli_runs):
    assert "Training Epoch - 2" in cli_runs["cut2"]
    assert "Training Epoch - 1" not in cli_runs["cut2"]
    assert stats_of(cli_dir, "cut") == stats_of(cli_dir, "whole")
    a = torch.load(cli_dir / "whole" / "whole_model.ckpt", weights_only=True)["model"]
    b = torch.load(cli_dir / "cut" / "cut_model.ckpt", weights_only=True)["model"]
    for name, p in a.items():
        assert torch.equal(p, b[name]), name


def test_cli_two_ranks_test_prints_the_metrics_once(cli_runs):
    lines = cli_runs["test"].splitlines()
    names = [f"R@{n}, IoU={m}" for n in (1, 5) for m in (0.1, 0.3, 0.5, 0.7)]
    assert [line.split(" - ")[0] for line in lines[:8]] == names
    assert lines[8].startswith("throughput - ") and len(lines) == 9
    assert all(0.0 <= float(line.split(" - ")[1]) <= 1.0 for line in lines[:8])
