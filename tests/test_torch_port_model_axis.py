"""PyTorch port, the model axis (``train.mesh.model``, ``parallel/tensor.py``):
column-sharded weights and their Adam moments over the mesh's model groups,
here gloo ranks on the CPU at the ``bench.py --small`` widths (the JAX
package's ``TINY_OVERRIDES`` widths) in float32, with
``train.mesh.min_shard_width=1`` so that the sharding is not vacuous, as
the JAX package's model-axis cases do.

- The rule at full width, without a step: the JAX package's
  ``param_spec`` over the default model (``jax.eval_shape``), carried
  through ``io/jax_weights.py``'s names, picks exactly the parameters the
  port's rule picks at ``model`` 2 / 4 / 8 (55,184,384 / 52,038,656 /
  46,795,776 of 66,539,716); the rule's edge cases
  (``tests/test_parallel.py::test_param_spec_rules``).
- Steps against JAX: ``data=1 x model=2`` (two ranks; also under
  ``rssm.remat`` true and "conv", each bit-equal to the step without it),
  ``data=2 x model=2`` and ``data=2 x model=2, grad_accum=2`` (four
  ranks), a clipped Adam step, deterministic, against the JAX package's
  single-device step on the same global batch, at the tolerances of
  ``tests/sharded_cases.py``: the loss within rtol 1e-5;
  ``case_model_axis``'s two-tier bound (all but 5e-4 of the elements
  within rtol 2e-2 / atol 5e-4, every one within 2 lr) without
  ``grad_accum``, ``case_grad_accum``'s (rtol 2e-4 / atol 2e-5) with it; the
  gradient norms (the clip's) and the other metrics at rtol 1e-4 and the
  BatchNorm running stats at rtol 1e-4, atol 1e-6 x the largest (as
  ``test_torch_port_parallel.py``).
- The ranks agree: every rank ends with the same whole parameters and
  running stats, bit for bit; each rank's blocks are its columns of the
  whole; a model group's ranks hold the same rows.
- The CLI end to end, ``data=2 x model=2``: 3 steps with checkpoints and
  histograms, ``--resume`` to 5 against an uninterrupted 5-step run (equal
  metrics, histograms and checkpoint; the histograms count whole
  tensors); the checkpoint holds whole tensors and loads mesh-less and
  into a ``data=1`` (model 1) run.
- The mesh's sizes and its refusals of a world it does not cover.

Every world starts in one module fixture (``torch_port_parallel_cases.py``
holds the ranks' code) with its own ``file://`` rendezvous and a hard
timeout.
"""

import functools
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.models.world_model import WorldModel as JaxWorldModel
from multimodal_rssm_tpu.parallel import mesh as jax_mesh
from torch import nn

from multimodal_rssm_torch.cli import train as cli_train
from multimodal_rssm_torch.core.config import compose
from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset
from multimodal_rssm_torch.io import checkpoint as ckpt
from multimodal_rssm_torch.io.jax_weights import state_dict_from_jax
from multimodal_rssm_torch.models.layers import BatchNorm, GRUCell
from multimodal_rssm_torch.models.world_model import WorldModel
from multimodal_rssm_torch.parallel import launch
from multimodal_rssm_torch.parallel import mesh as mesh_lib
from multimodal_rssm_torch.parallel import digests
from multimodal_rssm_torch.parallel import tensor as tensor_lib
from multimodal_rssm_torch.train import trainer as tr

import torch_port_parallel_cases as cases
from test_torch_port_codecs import SMALL, _batch, _bridged
from test_torch_port_parallel import (
    WORLD_TIMEOUT_S, _assert_two_tier, _checkpoint, _close, _in_background,
    _jax_step, _logged, _same)
from torch_port_tmp import _remove_module_tmp  # noqa: E402,F401

B = 4
OVER = SMALL + [f"train.batch_size={B}", "train.mesh.min_shard_width=1"]
CASES = {   # name -> (world size, overrides)
    "data1_model2": (2, ["train.mesh.data=1", "train.mesh.model=2"]),
    "data2_model2": (4, ["train.mesh.data=2", "train.mesh.model=2"]),
    "data2_model2_accum2": (4, ["train.mesh.data=2", "train.mesh.model=2",
                                "train.grad_accum=2"]),
    # the codecs rematerialised: the backward's recompute runs the
    # column-parallel layers' gathers again (under "conv", through the
    # selective-checkpoint policy)
    "data1_model2_remat": (2, ["train.mesh.data=1", "train.mesh.model=2",
                               "rssm.remat=true"]),
    "data1_model2_remat_conv": (2, ["train.mesh.data=1",
                                    "train.mesh.model=2", "rssm.remat=conv"]),
}
# sharded_cases.py: case_model_axis, case_grad_accum
TOLERANCE = {"data1_model2": (2e-2, 5e-4), "data2_model2": (2e-2, 5e-4),
             "data2_model2_accum2": (2e-4, 2e-5),
             "data1_model2_remat": (2e-2, 5e-4),
             "data1_model2_remat_conv": (2e-2, 5e-4)}
SHAPES = {"image_horizon": [3, 64, 64], "sound": [128, 20]}
FULL_WIDTH = 66_539_716


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _world(fn, nprocs, *args):
    """A world of ``nprocs`` ranks running ``fn`` in the background."""
    def run():
        with launch.file_rendezvous() as init_method:
            launch.spawn(fn, nprocs, (nprocs, init_method, *args),
                         timeout=WORLD_TIMEOUT_S)

    return _in_background(run)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("model_axis_data")
    write_synthetic_dataset(str(root / "train"), 2, 30, SHAPES)
    write_synthetic_dataset(str(root / "val"), 1, 30, SHAPES, seed=9)
    return root


def _cli_args(data_dir, *extra):
    return OVER + [
        f"train.train_data_path=[{data_dir}/train]",
        f"train.validation_data_path=[{data_dir}/val]",
        "train.chunk_size=4", "train.validation_interval=2",
        "train.experience_size=200", "train.checkpoint_interval=1",
        "train.histogram_interval=2", *extra,
        "--device", "cpu", "--cwd", str(data_dir), "--dist-timeout", "300"]


MESH = ["train.mesh.data=2", "train.mesh.model=2"]


# fresh CLI worlds of one step whose ranks record their staged digests:
# name -> the rank that flips one bit of its first raw batch (or None)
DIGEST_WORLDS = {"fresh": None, "again": None, "flipped_bit": 1}


def _digest_worlds(tmp, data_dir):
    """``DIGEST_WORLDS`` one after another, each a ``data=2 x model=2``
    world of the train CLI for one step in four fresh processes; each
    rank's staged digests by world."""
    out = tmp / "digest_worlds"
    out.mkdir()
    for name, flip in DIGEST_WORLDS.items():
        argv = [a for a in _cli_args(data_dir, *MESH,
                                     "train.train_iteration=1",
                                     f"main.experiment_name=dw_{name}")
                if not a.startswith(("train.checkpoint_interval",
                                     "train.histogram_interval"))]
        with launch.file_rendezvous() as init_method:
            launch.spawn(cases.cli_digest_world, 4,
                         (4, init_method, argv, name, str(out), flip),
                         timeout=WORLD_TIMEOUT_S)
    return {name: [torch.load(str(out / f"{name}_{r}.pt"))
                   for r in range(4)] for name in DIGEST_WORLDS}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, data_dir):
    """Every world of the module, started together in the background: the
    step cases of two and of four ranks, and through the CLI the
    uninterrupted 5-step run and the 3-step run that a test resumes."""
    tmp = tmp_path_factory.mktemp("model_axis_worlds")
    jcfg, cfg, jm, variables = _bridged(tuple([f"train.batch_size={B}"]))
    jbatch, pbatch = _batch(cfg, 2, Bn=B)
    inputs = {"overrides": OVER, "cases": CASES, "batch": pbatch,
              "digested": "data2_model2",
              "state_dict": state_dict_from_jax(variables["params"],
                                                variables["batch_stats"])}
    torch.save(inputs, str(tmp / "inputs.pt"))
    (tmp / "steps").mkdir()
    joins = {
        "two": _world(cases.model_axis_world, 2, str(tmp / "inputs.pt"),
                      str(tmp / "steps")),
        "four": _world(cases.model_axis_world, 4, str(tmp / "inputs.pt"),
                       str(tmp / "steps")),
        "straight": _in_background(cli_train.main, _cli_args(
            data_dir, *MESH, "train.train_iteration=5",
            "main.experiment_name=mp_5")),
        "first": _in_background(cli_train.main, _cli_args(
            data_dir, *MESH, "train.train_iteration=3",
            "main.experiment_name=mp_3")),
        "digests": _in_background(_digest_worlds, tmp, data_dir),
    }
    return {"joins": joins, "dir": tmp, "inputs": inputs,
            "jax": (jcfg, jm, variables, jbatch)}


@pytest.fixture(scope="module")
def steps(worlds):
    """Each case's per-rank results beside the JAX package's steps."""
    jcfg, jm, variables, jbatch = worlds["jax"]
    jax_steps = {1: _jax_step(jm, jcfg, variables, jbatch),
                 2: _jax_step(jm, jcfg, variables, jbatch, 2)}
    worlds["joins"]["two"]()
    worlds["joins"]["four"]()
    out = worlds["dir"] / "steps"
    ranks = {name: [torch.load(str(out / f"{name}_{r}.pt"))
                    for r in range(size)]
             for name, (size, _) in CASES.items()}
    refusals = [torch.load(str(out / f"refusals_{r}.pt")) for r in (0, 1)]
    return {"jax": jax_steps, "ranks": ranks, "refusals": refusals}


# -- the rule -----------------------------------------------------------------


@pytest.fixture(scope="module")
def full_width():
    """The JAX package's default model's parameter shapes
    (``jax.eval_shape`` of its init) and the port's default model on the
    ``meta`` device."""
    jcfg = jax_compose(overrides=["rssm.remat=false"])
    jm = JaxWorldModel.from_config(jcfg)
    obs = {}
    for name in jcfg.rssm.observation_names_enc:
        shape = tuple(jcfg.env.observation_shapes[name])
        if "image" in name:   # NHWC
            shape = (*shape[1:], shape[0])
        obs[name] = jax.ShapeDtypeStruct((2, 1, *shape), jnp.float32)
    act = jax.ShapeDtypeStruct((2, 1, int(jcfg.env.action_size)),
                               jnp.float32)
    variables = jax.eval_shape(functools.partial(jm.init, train=False),
                               jax.random.PRNGKey(0), obs, act, None, None)
    with torch.device("meta"):
        model = WorldModel.from_config(compose())
    return variables["params"], model


@pytest.mark.parametrize("n_model,want", [
    (2, 55_184_384), (4, 52_038_656), (8, 46_795_776)])
def test_rule_at_full_width_shards_what_the_jax_rule_shards(
        full_width, n_model, want):
    """Each JAX leaf marked by whether ``param_spec`` shards it, carried
    into the port's names by ``state_dict_from_jax`` (a joined layer's
    marks side by side): every port weight the port's rule shards is
    marked whole, every other parameter not at all."""
    params, model = full_width
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    jax_count = sum(
        int(np.prod(leaf.shape)) for path, leaf in leaves
        if jax_mesh.param_spec(path, leaf, n_model) != P())
    marks = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.broadcast_to(
            np.bool_(jax_mesh.param_spec(path, leaf, n_model) != P()),
            leaf.shape), params)
    bridged = state_dict_from_jax(marks)
    named = dict(model.named_parameters())
    assert set(bridged) == set(named)
    spec = tensor_lib.param_spec(model, n_model)
    for name, mark in bridged.items():
        assert bool(mark.all()) == (name in spec), name
        assert bool(mark.all()) or not bool(mark.any()), name
    assert sum(named[n].numel() for n in spec) == want == jax_count
    assert sum(p.numel() for p in named.values()) == FULL_WIDTH
    assert not any(".rnn." in n or not n.endswith(".weight") for n in spec)


def _spec(layer, n_model=2, min_width=tensor_lib.MIN_SHARD_WIDTH):
    return tensor_lib.param_spec(nn.Sequential(layer), n_model, min_width)


def test_rule_edge_cases():
    """The JAX package's ``test_param_spec_rules`` on the port's layers:
    only wide layer weights, on their output features."""
    assert _spec(nn.Linear(64, 256)) == {"0.weight": 0}
    # a small matrix whose width divides the axis stays replicated ...
    assert _spec(nn.Linear(4, 4)) == {}
    # ... unless min_shard_width allows it
    assert _spec(nn.Linear(4, 4), min_width=1) == {"0.weight": 0}
    assert _spec(nn.Linear(64, 255)) == {}   # indivisible
    assert _spec(nn.Linear(64, 256), n_model=1) == {}
    assert _spec(nn.Conv2d(64, 256, 3)) == {"0.weight": 0}
    assert _spec(nn.Conv1d(64, 256, 1)) == {"0.weight": 0}
    assert _spec(nn.ConvTranspose2d(64, 256, 3)) == {"0.weight": 1}
    assert _spec(nn.Conv2d(64, 256, 3, groups=2)) == {}
    # norms' scales, biases and the GRU cell stay replicated at any width
    assert _spec(BatchNorm(512), min_width=1) == {}
    assert _spec(GRUCell(64, 256), min_width=1) == {}


def test_mesh_sizes_and_refusals_of_the_model_axis(steps):
    """``train.mesh`` with ``model``: the data axis takes the ranks left
    after slice x model; a mesh the world does not cover raises on every
    rank."""
    cfg = lambda *o: compose(overrides=[f"train.mesh.{x}" for x in o])
    assert mesh_lib.mesh_sizes(cfg("data=1", "model=2")) == (1, 1, 2)
    assert mesh_lib.mesh_sizes(cfg("data=2", "model=2")) == (1, 2, 2)
    assert mesh_lib.mesh_sizes(cfg("model=2"), 8) == (1, 4, 2)
    assert mesh_lib.mesh_sizes(cfg("slice=2", "data=-1", "model=2"),
                               8) == (2, 2, 2)
    with pytest.raises(ValueError, match="every rank left"):
        mesh_lib.mesh_sizes(cfg("model=2"))
    for refusals in steps["refusals"]:
        assert "needs 4 ranks, the world has 2" in refusals["mesh"]
        assert "needs 4 ranks, the world has 2" in refusals["create_mesh"]
        assert "no data axis left after slice 1 x model 4" in (
            refusals["no_data"])


# -- the steps ----------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_model_axis_step_matches_the_jax_single_device_step(steps, case):
    j = steps["jax"][2 if "accum" in case else 1]
    rtol, atol = TOLERANCE[case]
    for p in steps["ranks"][case]:
        np.testing.assert_allclose(p["metrics"]["loss"], j["loss"],
                                   rtol=1e-5)
        for k, v in j["metrics"].items():   # grad_norm_*: the clip's norm
            _close(p["metrics"][k], v, 1e-4, 1e-6, k)
        _assert_two_tier(p["params"], j["params"], rtol, atol)
        for name, v in p["stats"].items():
            _close(v.numpy(), j["stats"][name].numpy(), 1e-4, 1e-6, name)


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_agree_and_hold_their_columns(steps, worlds, case):
    """Every rank ends with the same whole parameters, running stats and
    metrics, bit for bit; each rank's blocks are its columns of the whole
    weight, of the weights the rule shards at min_shard_width 1."""
    ranks = steps["ranks"][case]
    first = ranks[0]
    model = WorldModel.from_config(compose(overrides=OVER))
    spec = tensor_lib.param_spec(model, 2, 1)
    assert spec and set(first["blocks"]) == set(spec)
    for got in ranks:
        for part in ("params", "stats"):
            assert first[part].keys() == got[part].keys()
            for name in first[part]:
                assert torch.equal(first[part][name], got[part][name]), (
                    part, name)
        assert got["metrics"] == first["metrics"]
        for name, dim in spec.items():
            whole = got["params"][name]
            n = whole.shape[dim] // 2
            assert got["blocks"][name].shape[dim] == n
            assert torch.equal(got["blocks"][name], whole.narrow(
                dim, got["model_rank"] * n, n)), name
    assert any("running_mean" in k for k in first["stats"])   # BatchNorm


def test_staged_digests_of_a_model_axis_step_repeat_bit_for_bit(steps):
    """``data=2 x model=2``: the same step run twice in one world gives
    bit-equal staged digests (``parallel/digests.py``) on every rank, at
    every stage and for every RSSM step's operands of the GRU's
    input-to-hidden product; the stages say what each should: a model
    group's ranks (same rows) agree before any collective, the data
    group's average and the broadcast leave every replicated gradient one
    over the world, and a sharded weight's block one over its data group
    (the step under the instrument equals the JAX package's:
    ``test_model_axis_step_matches_the_jax_single_device_step``)."""
    ranks = steps["ranks"]["data2_model2"]
    for p in ranks:
        first, again = p["digests"]
        assert digests.first_parting(first, again) is None
        rec = first[0]
        assert tuple(rec["stages"]) == digests.STAGES
        assert rec["gru"], "no GRU call digested"
        for row in rec["gru"]:
            assert None not in row.values(), row
            assert row["x_forward"] == row["x_backward"]
            assert row["product_recomputed_equal"] is True
    stages = [p["digests"][0][0]["stages"] for p in ranks]
    names = set(stages[0]["local"])   # the parameters the loss reaches
    blocks = set(ranks[0]["blocks"]) & names
    assert blocks and blocks < names
    by_model = {m: [r for r, p in enumerate(ranks) if p["model_rank"] == m]
                for m in (0, 1)}
    for name in names - blocks:
        for group in ((0, 1), (2, 3)):   # the model groups: the same rows
            assert len({stages[r]["local"][name] for r in group}) == 1, name
        for stage in ("data_mean", "broadcast"):
            assert len({s[stage][name] for s in stages}) == 1, (stage, name)
    assert any(stages[0]["local"][n] != stages[2]["local"][n]
               for n in names - blocks)   # the data groups' rows differ
    for name in blocks:
        for ranks_m in by_model.values():
            for stage in ("data_mean", "broadcast"):
                assert len({stages[r][stage][name] for r in ranks_m}) == 1


@pytest.mark.parametrize("world", ["again", "flipped_bit"])
def test_staged_digests_of_fresh_model_axis_cli_worlds(worlds, world):
    """``data=2 x model=2`` through the train CLI for one step, each world
    in four fresh processes (where F6 showed on the card): every rank
    records every stage, ``inputs`` (the raw batch, the prepared batch, the
    weights after the broadcast and the shard, the generator), ``forward``
    (the encoders' embeddings, each RSSM step's GRU input, belief and
    posterior), ``kernels`` (on the CPU the operators of the step, in
    order) and the three gradient stages.  A second fresh world ("again")
    gives the same digests at every stage on every rank; one bit flipped
    in rank 1's raw batch ("flipped_bit") is reported at stage ``inputs``
    on rank 1 alone, as that raw tensor (K1 quantises the low bit away,
    so nothing after the raw batch moves)."""
    got = worlds["joins"]["digests"]()
    for rank, (base, other) in enumerate(zip(got["fresh"], got[world])):
        rec = base[0]
        assert tuple(rec["stages"]) == digests.STAGES
        inputs, forward = rec["stages"]["inputs"], rec["stages"]["forward"]
        for prefix in ("raw/observations/", "prepared/observations/",
                       "param/", "buffer/"):
            assert any(k.startswith(prefix) for k in inputs), prefix
        assert "generator" in inputs
        assert {"encoder/image_horizon", "encoder/sound"} <= set(forward)
        for key in ("gru_input", "belief", "posterior_mean",
                    "posterior_std", "posterior_sample"):
            assert f"rssm/000/{key}" in forward, key
        assert rec["stages"]["kernels"], "no kernel recorded"
        parting = digests.first_parting(base, other)
        if world == "flipped_bit" and rank == 1:
            assert parting["first_stage"] == "inputs", parting
            assert parting["first"] == "raw/observations/image_horizon"
            assert parting["stages"] == {
                "inputs": ["raw/observations/image_horizon"]}, parting
        else:
            assert parting is None, (rank, parting)


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_init_draws_on_one_thread_whatever_the_caller_sets(monkeypatch,
                                                           threads):
    """F6's repair: ``init_parameters`` makes every draw on one intra-op
    thread and gives the caller's thread count back, so its bits do not
    depend on the threads a process has (on the H100's host, the first
    parameter drawn once came out one row apart in a fresh process with
    several threads; a torch that draws the truncated normal by rejection
    did not show it in any process, so the test holds the mechanism and
    the bits)."""
    from multimodal_rssm_torch.models import world_model as wm

    cfg = compose(overrides=OVER)
    seen = []
    draw = torch.nn.init.trunc_normal_

    def counted(*args, **kwargs):
        seen.append(torch.get_num_threads())
        return draw(*args, **kwargs)

    before = torch.get_num_threads()
    try:
        torch.set_num_threads(threads)
        model = WorldModel.from_config(cfg)
        monkeypatch.setattr(torch.nn.init, "trunc_normal_", counted)
        wm.init_parameters(model, torch.Generator().manual_seed(0))
        assert torch.get_num_threads() == threads
    finally:
        torch.set_num_threads(before)
    assert seen and set(seen) == {1}
    monkeypatch.undo()
    reference = WorldModel.from_config(cfg)
    wm._draw_parameters(reference, torch.Generator().manual_seed(0))
    for (n, p), q in zip(model.named_parameters(), reference.parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("case", ["data1_model2_remat",
                                  "data1_model2_remat_conv"])
def test_remat_model_axis_step_equals_the_step_without_it(steps, case):
    """Under ``rssm.remat`` (whole, and the selective "conv" policy) each
    rank ends bit-equal to its rank of the step without remat: metrics,
    whole parameters, its blocks and the running stats (updated once)."""
    for got, base in zip(steps["ranks"][case],
                         steps["ranks"]["data1_model2"]):
        assert got["metrics"] == base["metrics"]
        for part in ("params", "blocks", "stats"):
            assert got[part].keys() == base[part].keys(), part
            for name, v in base[part].items():
                assert torch.equal(got[part][name], v), (part, name)


def test_a_model_group_shares_its_rows(steps):
    """Ranks are contiguous along ``model``: rank = data rank x 2 + model
    rank, and the rows follow the data rank."""
    r = steps["ranks"]
    assert r["data1_model2"][0]["mesh"] == {"data": 1, "model": 2}
    assert r["data2_model2"][0]["mesh"] == {"data": 2, "model": 2}
    for name, rows in (("data1_model2", [[0, 1, 2, 3]] * 2),
                       ("data2_model2", [[0, 1], [0, 1], [2, 3], [2, 3]]),
                       ("data2_model2_accum2", [[0, 2], [0, 2], [1, 3],
                                                [1, 3]])):
        got = r[name]
        assert [x["rows"] for x in got] == rows
        assert [(x["data_rank"], x["model_rank"]) for x in got] == [
            (rank // 2, rank % 2) for rank in range(len(got))]
        assert {x["model_size"] for x in got} == {2}


# -- the CLI ------------------------------------------------------------------


def _key(line):
    return json.dumps(line, sort_keys=True)


def test_cli_resume_equals_the_uninterrupted_model_axis_run(worlds,
                                                            data_dir):
    first = worlds["joins"]["first"]()
    run_dir = first["results_dir"]
    resumed = cli_train.main(["train.train_iteration=5", "--resume",
                              run_dir, "--device", "cpu", "--cwd",
                              str(data_dir), "--dist-timeout", "300"])
    straight = worlds["joins"]["straight"]()
    assert first["start_step"] == 0 and resumed["start_step"] == 3
    assert resumed["results_dir"] == run_dir
    for name in ("mp_3", "mp_5"):
        runs = glob.glob(str(data_dir / "results" / name / "*" / "run_*"))
        assert len(runs) == 1, runs
    # the same lines (``_logged`` leaves out the frame lines: none follows
    # the first process's last train line)
    logged = _logged(run_dir)
    assert sorted(map(_key, logged)) == sorted(map(
        _key, _logged(straight["results_dir"])))
    # histograms of whole tensors: a mesh-less model's counts
    model = WorldModel.from_config(compose(overrides=OVER))
    for prefix in ("params", "grads"):
        hists = [r for r in logged if f"{prefix}_encoder/hist" in r]
        assert [r["step"] for r in hists] == [2, 4]
        for r in hists:
            for name, child in model.named_children():
                assert r[f"{prefix}_{name}/hist"]["count"] == sum(
                    p.numel() for p in child.parameters()), (prefix, name)
    a = _checkpoint(run_dir, 5)
    b = _checkpoint(straight["results_dir"], 5)
    for part in ("model", "optimizer", "extra"):
        assert _same(a[part], b[part]), part


def test_model_axis_checkpoint_is_whole_and_loads_without_the_axis(
        worlds, data_dir):
    """``models_3.pt`` of the 3-step run holds whole tensors (a mesh-less
    model's shapes, Adam's moments too), loads strictly into a mesh-less
    model and optimizer, and starts a ``data=1`` run (model 1)."""
    path = os.path.join(worlds["joins"]["first"]()["results_dir"],
                        "models_3.pt")
    cfg = compose(overrides=OVER)
    model = WorldModel.from_config(cfg)
    opt, sched = tr.build_optimizer(cfg, model)
    step, _ = ckpt.load_checkpoint(path, model, opt, sched)
    assert step == 3
    saved = torch.load(path, weights_only=False)
    for name, p in model.named_parameters():
        assert saved["model"][name].shape == p.shape, name
        assert torch.equal(p.detach(), saved["model"][name]), name
    assert opt.state
    for p, state in opt.state.items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert state[key].shape == p.shape
    result = cli_train.main(_cli_args(
        data_dir, "train.mesh.data=1", "train.train_iteration=1",
        "train.checkpoint_interval=0", f"train.model_path={path}",
        "main.experiment_name=mp_from_3"))
    assert np.isfinite(result["metrics"]["loss"])
