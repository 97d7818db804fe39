"""PyTorch port, data-parallel training (``parallel/``): ``train.mesh.data`` /
``train.mesh.slice`` as ranks of a ``torch.distributed`` world, here gloo
ranks on the CPU at the ``bench.py --small`` widths in float32, with
BatchNorm in the image codec (the default configuration's).

One world of two ranks (a module fixture, ``torch_port_parallel_cases.py``)
runs every step case on the same weights and batches while this process
computes the JAX package's single-device steps on the whole batch:

- ``data=2``, ``slice=2, data=1`` and ``data=2, grad_accum=2`` (a clipped
  Adam step, deterministic) against the JAX package's step (and its
  ``grad_accum=2`` step) on the same global batch, at the JAX package's own
  data-parallel tolerance (``tests/sharded_cases.py``): the loss within
  rtol 1e-5; the parameters all but 5e-4 of them within rtol 2e-4 / atol
  2e-5, every one within 2 lr (Adam's first step turns a float32
  difference of a gradient near zero into up to 2 lr: 3 of 32,741
  elements of one kernel here); the other metrics at rtol 1e-4 and the
  BatchNorm running stats at rtol 1e-4, atol 1e-6 x the largest (as
  ``test_torch_port_train.py``), and both equal on the two ranks bit for
  bit, as are the parameters;
- the whole train step (the input pipeline's noise and PCA draws, K1's
  plain version, the sampled rollout) and a validation step on two ranks
  against one process of the port on the same raw batch and seed: the
  same draws, so the loss within rtol 1e-5 and the parameters within the
  JAX package's two-tier bound (all but 5e-4 of the elements within rtol
  2e-4 / atol 2e-5, every one within 2 lr).

Two more worlds: every feed's local blocks gathered back to the global
batch (exactly), and the train CLI under a SIGTERM to one rank.  Through
the CLI, which starts its ranks itself: a 4-step run with checkpoints,
``--resume`` to 6, against an uninterrupted 6-step run (equal metrics and
checkpoint, one run dir).  Every world has its own ``file://`` rendezvous
and a hard timeout (collectives time out first).
"""

import glob
import json
import os
import threading

import jax
import numpy as np
import optax
import pytest
import torch
from multimodal_rssm_tpu.train import trainer as jtr

from multimodal_rssm_torch.cli import train as cli_train
from multimodal_rssm_torch.core.config import compose
from multimodal_rssm_torch.data.buffer import build_buffer, load_dataset
from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset
from multimodal_rssm_torch.io.jax_weights import state_dict_from_jax
from multimodal_rssm_torch.ops import cuda_kernels as ck
from multimodal_rssm_torch.parallel import launch
from multimodal_rssm_torch.parallel import mesh as mesh_lib
from multimodal_rssm_torch.train import loop
from multimodal_rssm_torch.train import trainer as tr

import torch_port_parallel_cases as cases
from test_torch_port_codecs import SMALL, _batch, _bridged, _np_tree
from torch_port_tmp import _remove_module_tmp  # noqa: E402,F401

WORLD_TIMEOUT_S = 600.0
B, LR = 4, 1e-3
OVER = SMALL + [f"train.batch_size={B}"]
NOISY = ["train.augmentation.noise_scales=[0.0,0.2]",
         "train.augmentation.pca_scales=[0.1]", "train.chunk_size=4",
         "train.experience_size=200"]
STEP_CASES = {
    "data2": ("deterministic", ["train.mesh.data=2"]),
    "slice2": ("deterministic", ["train.mesh.slice=2", "train.mesh.data=1"]),
    "data2_accum2": ("deterministic", ["train.mesh.data=2",
                                       "train.grad_accum=2"]),
    "full_data2": ("full", NOISY + ["train.mesh.data=2"]),
    "full_data2_accum2": ("full", NOISY + ["train.mesh.data=2",
                                           "train.grad_accum=2"]),
}
SHAPES = {"image_horizon": [3, 64, 64], "sound": [128, 20]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _in_background(fn, *args):
    """``fn(*args)`` on a thread; the returned ``join()`` waits at most
    ``WORLD_TIMEOUT_S`` and raises its error."""
    box = {}

    def target():
        try:
            box["value"] = fn(*args)
        except BaseException as e:   # raised by join()
            box["error"] = e

    thread = threading.Thread(target=target, daemon=True)
    thread.start()

    def join():
        thread.join(WORLD_TIMEOUT_S)
        assert not thread.is_alive(), f"{fn} still running"
        if "error" in box:
            raise box["error"]
        return box.get("value")

    return join


def _world(fn, *args):
    """A 2-rank world running ``fn`` in the background."""
    def run():
        with launch.file_rendezvous() as init_method:
            launch.spawn(fn, 2, (2, init_method, *args),
                         timeout=WORLD_TIMEOUT_S)

    return _in_background(run)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_data")
    write_synthetic_dataset(str(root / "train"), 2, 30, SHAPES)
    write_synthetic_dataset(str(root / "val"), 1, 30, SHAPES, seed=9)
    return root


def _cli_args(data_dir, *extra):
    return SMALL + [
        f"train.train_data_path=[{data_dir}/train]",
        f"train.validation_data_path=[{data_dir}/val]",
        f"train.batch_size={B}", "train.chunk_size=4",
        "train.validation_interval=2", "train.experience_size=200",
        "train.checkpoint_interval=2", "train.mesh.data=2", *extra,
        "--device", "cpu", "--cwd", str(data_dir), "--dist-timeout", "300"]


def _raw_batches(cfg, data_dir):
    """A raw global train and validation batch of a seeded buffer, the
    augmentation structure and one draw of its choices."""
    D = build_buffer(cfg, seed=11)
    load_dataset(str(data_dir), D, "train")
    spec = tr.build_aug_spec(D)
    to_t = lambda b: ({k: torch.from_numpy(v) for k, v in b[0].items()},
                      *(torch.from_numpy(x) for x in b[1:]))
    L = int(cfg.train.chunk_size)
    return ({"batch": to_t(D.sample(B, L)), "spec": spec,
             "draws": tr.HostAugmentDraws(D, spec, seed=2).draw()},
            to_t(D.sample(B, L)))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data_dir):
    """Every world of the module, started together in the background (each
    takes seconds to start and the ranks run one thread each): the step
    cases, the feeds, the SIGTERM run, and through the CLI the
    uninterrupted 6-step run and the 4-step run that a test resumes.
    Returns the joins, the step world's inputs and the output dirs."""
    tmp = tmp_path_factory.mktemp("parallel_worlds")
    jcfg, cfg, jm, variables = _bridged(tuple([f"train.batch_size={B}"]))
    jbatch, pbatch = _batch(cfg, 2, Bn=B)
    state_dict = state_dict_from_jax(variables["params"],
                                     variables["batch_stats"])
    raw, val_raw = _raw_batches(compose(overrides=OVER + NOISY), data_dir)
    inputs = {"overrides": OVER, "cases": STEP_CASES,
              "state_dict": state_dict, "batch": pbatch, "raw": raw,
              "val_raw": val_raw, "seed": 7}
    torch.save(inputs, str(tmp / "inputs.pt"))
    for name in ("steps", "feed", "sigterm"):
        (tmp / name).mkdir()
    joins = {
        "steps": _world(cases.step_world, str(tmp / "inputs.pt"),
                        str(tmp / "steps")),
        "feed": _world(cases.feed_world, SMALL + NOISY + [
            f"train.batch_size={B}", "train.mesh.data=2",
            "train.grad_accum=2"], str(data_dir), str(tmp / "feed")),
        "sigterm": _world(cases.sigterm_world, _cli_args(
            data_dir, "train.train_iteration=8",
            "train.checkpoint_interval=0", "main.experiment_name=dp_sigterm"),
            1, 3, str(tmp / "sigterm")),
        "straight": _in_background(cli_train.main, _cli_args(
            data_dir, "train.train_iteration=6", "main.experiment_name=dp_6")),
        "first": _in_background(cli_train.main, _cli_args(
            data_dir, "train.train_iteration=4", "main.experiment_name=dp_4")),
    }
    return {"joins": joins, "dir": tmp, "inputs": inputs,
            "jax": (jcfg, jm, variables, jbatch)}


@pytest.fixture(scope="module")
def steps(worlds):
    """The step world's per-rank results beside the JAX package's and the
    one-process port's steps."""
    jcfg, jm, variables, jbatch = worlds["jax"]
    inputs = worlds["inputs"]
    jax = {1: _jax_step(jm, jcfg, variables, jbatch),
           2: _jax_step(jm, jcfg, variables, jbatch, 2)}
    one = {name: cases.full_step(
        compose(overrides=OVER + [o for o in over if "mesh" not in o]),
        inputs["state_dict"], inputs["raw"], inputs["val_raw"],
        inputs["seed"], None)
        for name, (kind, over) in STEP_CASES.items() if kind == "full"}
    worlds["joins"]["steps"]()
    out = worlds["dir"] / "steps"
    ranks = {name: [torch.load(str(out / f"{name}_{r}.pt")) for r in (0, 1)]
             for name in STEP_CASES}
    refusals = [torch.load(str(out / f"refusals_{r}.pt")) for r in (0, 1)]
    return {"jax": jax, "one": one, "ranks": ranks, "refusals": refusals}


def _jax_step(jm, jcfg, variables, jbatch, accum=1):
    """The JAX package's deterministic single-device step on the whole
    batch (``accumulated_value_and_grad`` for ``accum`` > 1) and its clipped
    Adam update, jitted as one program; the loss, the metrics with the
    gradient norms, the running stats and the parameters after, in the
    port's names."""
    loss_fn = jtr.make_loss_fn(jm, jcfg)
    optimizer = jtr.build_optimizer(jcfg)

    def step(params, stats, batch):
        if accum == 1:
            (loss, (stats, metrics)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, stats, batch, None, True)
        else:
            (loss, (stats, metrics)), grads = jtr.accumulated_value_and_grad(
                loss_fn, params, stats, batch=batch, key=None, accum=accum)
        metrics = dict(metrics, grad_norm=optax.global_norm(grads))
        for mod, sub in grads.items():
            metrics[f"grad_norm_{mod}"] = optax.global_norm(sub)
        updates, _ = optimizer.update(grads, optimizer.init(params), params)
        return loss, metrics, stats, optax.apply_updates(params, updates)

    loss, metrics, stats, params = jax.jit(step)(
        variables["params"], variables["batch_stats"], jbatch)
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "stats": state_dict_from_jax(variables["params"],
                                         _np_tree(stats)),
            "params": state_dict_from_jax(_np_tree(params), None)}


def _close(got, want, rtol, atol_scale, name):
    want = np.asarray(want)
    atol = atol_scale * float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol,
                               err_msg=name)


def _assert_two_tier(got, want, rtol=2e-4, atol=2e-5, max_loose=5e-4):
    """The JAX package's data-parallel bound (``sharded_cases.py``): every
    element within 2 lr, all but ``max_loose`` of them within (rtol,
    atol)."""
    total = loose = 0
    worst = 0.0
    for name, w in want.items():
        diff = (got[name].double() - w.double()).abs()
        loose += int((diff > atol + rtol * w.double().abs()).sum())
        total += diff.numel()
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    assert worst <= 2 * LR, worst
    assert loose <= max_loose * total, (loose, total)


# -- (i)-(iv): the steps ----------------------------------------------------------


@pytest.mark.parametrize("case", ["data2", "slice2", "data2_accum2"])
def test_sharded_step_matches_the_jax_single_device_step(steps, case):
    j = steps["jax"][2 if "accum" in case else 1]
    for p in steps["ranks"][case]:
        np.testing.assert_allclose(p["metrics"]["loss"], j["loss"],
                                   rtol=1e-5)
        for k, v in j["metrics"].items():
            _close(p["metrics"][k], v, 1e-4, 1e-6, k)
        _assert_two_tier(p["params"], j["params"])
        for name, v in p["stats"].items():
            _close(v.numpy(), j["stats"][name].numpy(), 1e-4, 1e-6, name)


def test_meshes_and_rows_of_the_step_cases(steps):
    r = steps["ranks"]
    assert r["data2"][0]["mesh"] == {"data": 2, "model": 1}
    assert r["slice2"][0]["mesh"] == {"slice": 2, "data": 1, "model": 1}
    assert [x["rows"] for x in r["data2"]] == [[0, 1], [2, 3]]
    assert [x["rows"] for x in r["slice2"]] == [[0, 1], [2, 3]]
    # micro-batch k of the global batch, sharded over the ranks
    assert [x["rows"] for x in r["data2_accum2"]] == [[0, 2], [1, 3]]


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_ranks_end_with_the_same_parameters_and_running_stats(steps, case):
    a, b = steps["ranks"][case]
    for part in ("params", "stats"):
        assert a[part].keys() == b[part].keys()
        for name in a[part]:
            assert torch.equal(a[part][name], b[part][name]), (part, name)
    assert a["metrics"] == b["metrics"]
    assert any("running_mean" in k for k in a["stats"])   # BatchNorm


@pytest.mark.parametrize("case", ["full_data2", "full_data2_accum2"])
def test_whole_train_step_draws_what_one_process_draws(steps, case):
    one, (p, _) = steps["one"][case], steps["ranks"][case]
    np.testing.assert_allclose(p["metrics"]["loss"], one["metrics"]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(p["validation"]["loss"],
                               one["validation"]["loss"], rtol=1e-5)
    for k, v in one["metrics"].items():
        _close(p["metrics"][k], v, 1e-4, 1e-6, k)
    _assert_two_tier(p["params"], one["params"])
    for name, v in p["stats"].items():
        _close(v.numpy(), one["stats"][name].numpy(), 1e-4, 1e-6, name)


# -- (vii) the feeds --------------------------------------------------------------


@pytest.fixture(scope="module")
def feeds(worlds):
    worlds["joins"]["feed"]()
    return [torch.load(str(worlds["dir"] / "feed" / f"feed_{r}.pt"))
            for r in (0, 1)]


def _leaves(batch):
    observations, *rest = batch
    return [observations[k] for k in sorted(observations)] + list(rest)


@pytest.mark.parametrize("kind", ["device", "stream", "host"])
def test_local_blocks_gather_to_the_global_batch(feeds, kind):
    """Each rank's block is its rows of a one-process draw from the same
    seed, and ``global_batch_from_local`` puts the blocks back into it."""
    for rank in (0, 1):
        got = feeds[rank][kind]
        for name in ("gathered", "local"):
            want = got["oracle"] if name == "gathered" else got["cut"]
            for x, y in zip(_leaves(got[name]), _leaves(want)):
                assert torch.equal(x, y), (kind, rank, name)
        assert _leaves(got["local"])[0].shape[1] == B // 2


# -- (viii) the mesh's config semantics and refusals ---------------------------


def _mesh_cfg(*over):
    return compose(overrides=[f"train.mesh.{o}" for o in over])


def test_mesh_sizes_follow_the_jax_package():
    assert mesh_lib.mesh_sizes(_mesh_cfg("data=0")) is None
    assert mesh_lib.mesh_sizes(_mesh_cfg("data=1")) == (1, 1, 1)
    assert mesh_lib.mesh_sizes(_mesh_cfg("data=2")) == (1, 2, 1)
    assert mesh_lib.mesh_sizes(_mesh_cfg("data=-1"), 4) == (1, 4, 1)
    assert mesh_lib.mesh_sizes(_mesh_cfg("slice=2"), 4) == (2, 2, 1)
    assert mesh_lib.mesh_sizes(_mesh_cfg("slice=2", "data=-1"), 8) == (
        2, 4, 1)
    assert mesh_lib.mesh_sizes(_mesh_cfg("model=2"), 4) == (1, 2, 2)
    with pytest.raises(ValueError, match="every rank left"):
        mesh_lib.mesh_sizes(_mesh_cfg("data=-1"))
    with pytest.raises(ValueError, match="no data axis"):
        mesh_lib.mesh_sizes(_mesh_cfg("slice=4", "data=-1"), 2)
    # no world: no mesh is one process, a mesh raises
    assert mesh_lib.mesh_from_config(_mesh_cfg("data=0")) is None
    with pytest.raises(RuntimeError, match="torch.distributed world"):
        mesh_lib.mesh_from_config(_mesh_cfg("data=2"), "cpu")


def test_rows_refuse_a_batch_the_ranks_do_not_divide():
    assert mesh_lib.local_rows(8, 1, 2, 2).tolist() == [2, 3, 6, 7]
    assert mesh_lib.local_rows(50, 1, 2).tolist() == list(range(25, 50))
    for batch, size, accum in ((50, 4, 1), (50, 2, 2), (6, 2, 2)):
        with pytest.raises(ValueError, match=(
                f"batch_size={batch} .* {size} ranks .*"
                f"grad_accum={accum}")):
            mesh_lib.local_rows(batch, 0, size, accum)


@pytest.mark.parametrize("visible,local_rank,want", [
    (4, 3, 3),    # every GPU of the host visible: the rank's own
    (1, 3, 0),    # the launcher bound one card to the rank
    (2, 3, None),  # the rank's card is missing
])
def test_a_rank_takes_its_card(monkeypatch, visible, local_rank, want):
    from multimodal_rssm_torch.core.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    if want is None:
        with pytest.raises(RuntimeError, match="cuda:3 is missing"):
            resolve_device("cuda")
    else:
        assert resolve_device("cuda") == torch.device("cuda", want)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert loop.ranks_per_device(torch.device("cpu"), None) == 1


@pytest.mark.parametrize("device,local_world,visible,want", [
    ("cuda", "4", 4, "nccl"),   # a card a rank
    ("cuda", "4", 1, "gloo"),   # four ranks sharing the one card
    ("cuda", "2", 1, "gloo"),
    ("cuda", None, 1, "nccl"),   # an explicit rendezvous, one rank a host
    ("cpu", "4", 0, "gloo"),
])
def test_ranks_sharing_a_card_join_over_gloo(monkeypatch, device,
                                             local_world, visible, want):
    """With no backend given, the ranks of a host join over NCCL unless
    they outnumber its visible cards (NCCL refuses two ranks on one card);
    the CPU's are gloo."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    assert mesh_lib.default_backend(torch.device(device)) == want


def test_mesh_refuses_a_world_it_does_not_cover(steps):
    """A mesh of 4 ranks in a world of 2, and a world of 2 without a mesh,
    raise on every rank."""
    for refusals in steps["refusals"]:
        assert "needs 4 ranks, the world has 2" in refusals["mesh_over_world"]
        assert "train.mesh.data" in refusals["world_without_mesh"]


# -- (ix) K1's global rows ----------------------------------------------------------


@pytest.mark.parametrize("size,accum", [(2, 1), (2, 2), (4, 1), (3, 2)])
def test_k1_plain_version_on_a_shard_draws_the_global_rows(size, accum):
    """On every rank's block (offset non-zero but for rank 0), K1's plain
    version with the shard's row map equals the rows of the one over the
    global batch, bit for bit; the identity map is the flat counter (the
    wrapper's result before row maps existed)."""
    Bg = 12
    x = torch.randint(0, 256, (5, Bg, 8, 8, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(size))
    seed = torch.tensor(2 ** 40 + 17, dtype=torch.int64)
    whole = ck.normalize_image_plain(x, 5, seed)
    for rank in range(size):
        shard = mesh_lib.BatchShard(Bg, rank, size, accum)
        rows = torch.from_numpy(shard.rows)
        local = ck.normalize_image(x[:, rows], 5, seed, shard.row_map)
        assert torch.equal(local, whole[:, rows]), rank
    identity = mesh_lib.BatchShard(Bg, 0, 1, 1).row_map
    assert torch.equal(ck.normalize_image(x, 5, seed, identity),
                       ck.normalize_image(x, 5, seed))


def test_k1_row_map_refuses_rows_outside_the_batch_and_ragged_rows():
    x = torch.zeros(2, 2, 3, 3, 1)
    seed = torch.tensor(1)
    with pytest.raises(ValueError, match="Philox groups"):
        ck.normalize_image(x, 5, seed, ck.RowMap(2, 4, 2, 2))
    with pytest.raises(ValueError, match="outside the global batch"):
        ck.normalize_image(torch.zeros(2, 2, 4, 1), 5, seed,
                           ck.RowMap(3, 4, 2, 2))


# -- (v), (vi) the CLI: resume, one run dir, an agreed stop ----------------------


def _logged(run_dir):
    """The metric and histogram lines without ``time``: not the perf lines
    (a resumed run has one a process) or the ``frame`` lines (none follows
    a process's last train line)."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [{k: v for k, v in r.items() if k != "time"}
                for r in map(json.loads, f)
                if "frame" not in r
                and not any(k.endswith("/perf") for k in r)]


def _same(a, b):
    """Equal nested state: tensors bit-equal, everything else ==."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _checkpoint(run_dir, step):
    return torch.load(os.path.join(run_dir, f"models_{step}.pt"),
                      weights_only=False)


def test_cli_resume_equals_the_uninterrupted_two_rank_run(worlds, data_dir):
    first = worlds["joins"]["first"]()
    run_dir = first["results_dir"]
    resumed = cli_train.main(["train.train_iteration=6", "--resume",
                              run_dir, "--device", "cpu", "--cwd",
                              str(data_dir), "--dist-timeout", "300"])
    straight = worlds["joins"]["straight"]()
    assert first["start_step"] == 0 and resumed["start_step"] == 4
    assert resumed["results_dir"] == run_dir
    # one run dir a run, written by rank 0 alone
    for name in ("dp_4", "dp_6"):
        runs = glob.glob(str(data_dir / "results" / name / "*" / "run_*"))
        assert len(runs) == 1, runs
    assert sorted(os.listdir(run_dir)) == [
        "hydra_config.yaml", "metrics.jsonl", "models_2.pt", "models_4.pt",
        "models_6.pt"]
    assert _logged(run_dir) == _logged(straight["results_dir"])
    a = _checkpoint(run_dir, 6)
    b = _checkpoint(straight["results_dir"], 6)
    for part in ("model", "optimizer", "extra"):
        assert _same(a[part], b[part]), part


def test_sigterm_to_one_rank_stops_every_rank_after_the_same_step(worlds):
    """Rank 1 alone gets SIGTERM during step 3 of 8; the ranks all-reduce
    their stop flags every step and read them a step later, so both finish
    step 4 and stop, and rank 0 writes models_4.pt."""
    worlds["joins"]["sigterm"]()
    got = [torch.load(str(worlds["dir"] / "sigterm" / f"sigterm_{r}.pt"))
           for r in (0, 1)]
    assert [len(r["step_seconds"]) for r in got] == [4, 4]
    assert all(r["preempted"] for r in got)
    run_dir = got[0]["results_dir"]
    assert got[1]["results_dir"] == run_dir
    assert sorted(p for p in os.listdir(run_dir) if p.endswith(".pt")) == [
        "models_4.pt"]
    assert _checkpoint(run_dir, 4)["step"] == 4
