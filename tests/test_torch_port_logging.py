"""PyTorch port, the train path's last parity gaps held against the JAX
package: the metric logger's wandb mirror (through the stub ``wandb``
module of ``tests/test_wandb_logging.py``: wandb is not installed) and its
``frame`` records, the train CLI with ``main.wandb=true`` (rank 0 alone
calls ``wandb.init``), the ``metrics.jsonl`` key sequence of a short run of
each package's loop, ``--config-name`` and ``$MRSSM_CONFIG_DIR``, the
``"observation"`` / ``"image"`` alias of the encoders, and the
``mrssm-torch-*`` console scripts.

Runs are at the ``bench.py --small`` widths in float32, batch 2 x chunk 4.
The embeddings through the alias are held to the JAX encoders' at rtol
1e-5, atol 1e-5 (the same float32 math, sums taken in another order; as
``test_torch_port_model.py``); the key sequences, ``frame`` values, stub
calls and composed configs are held equal exactly.
"""

import datetime
import importlib
import json
import os
import shutil
import sys
import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.io import metrics as jmetrics
from multimodal_rssm_tpu.models import encoders as jenc
from multimodal_rssm_tpu.train import loop as jloop
from multimodal_rssm_tpu.train import trainer as jtr
from test_wandb_logging import _StubHistogram, _make_stub_wandb

from multimodal_rssm_torch.cli import command
from multimodal_rssm_torch.cli import train as cli_train
from multimodal_rssm_torch.core.config import compose, default_config_dir
from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset
from multimodal_rssm_torch.io import metrics as pmetrics
from multimodal_rssm_torch.io.jax_weights import codec_state_dict
from multimodal_rssm_torch.models import encoders as penc
from multimodal_rssm_torch.models.world_model import WorldModel
from multimodal_rssm_torch.parallel import mesh as mesh_lib
from torch_port_tmp import _remove_module_tmp  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL = ["rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
         "rssm.embedding_size.image=64", "rssm.embedding_size.sound=32",
         "rssm.embedding_size.fusion=64", "rssm.embedding_size.other=16",
         "train.use_amp=False"]
B, L, STEPS = 2, 4, 4
RUN = SMALL + [f"train.batch_size={B}", f"train.chunk_size={L}",
               f"train.train_iteration={STEPS}", "train.validation_interval=2",
               "train.histogram_interval=2", "train.experience_size=200",
               "rssm.remat=false"]
EMB_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("logging")
    shapes = {"image_horizon": [3, 64, 64], "sound": [128, 20]}
    write_synthetic_dataset(str(root / "train"), 2, 40, shapes)
    write_synthetic_dataset(str(root / "val"), 1, 40, shapes, seed=9)
    return root


def _data(root):
    return [f"train.train_data_path=[{root}/train]",
            f"train.validation_data_path=[{root}/val]"]


def _lines(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _key_sequence(lines, names=None):
    """Each line's key set without ``time``, module names mapped by
    ``names``."""
    names = names or {}

    def key(k):
        head, sep, tail = k.partition("_")
        if tail.endswith("/hist") and head in ("params", "grads"):
            mod = tail[:-len("/hist")]
            return f"{head}_{names.get(mod, mod)}/hist"
        return k

    return [sorted(key(k) for k in r if k != "time") for r in lines]


def _expected_mirror(lines):
    """The wandb calls the JAX logger makes for these ``metrics.jsonl``
    lines: each scalar record without ``step`` / ``time`` at its step, each
    histogram line's finite modules as (counts, edges), no ``frame``."""
    calls = []
    for r in lines:
        if "frame" in r:
            continue
        hists = {k: v for k, v in r.items() if k.endswith("/hist")}
        if hists:
            calls.append(({k: (v["bin_counts"], v["bin_edges"])
                           for k, v in hists.items() if "bin_counts" in v},
                          r["step"]))
        else:
            calls.append(({k: v for k, v in r.items()
                           if k not in ("step", "time")}, r["step"]))
    return calls


def _as_lists(calls):
    """Stub ``log`` calls with each ``Histogram`` as (counts, edges)
    lists, its arrays' dtypes checked against ``np.histogram``'s."""
    out = []
    for metrics, step in calls:
        got = {}
        for k, v in metrics.items():
            if isinstance(v, _StubHistogram):
                counts, edges = v.np_histogram
                assert (counts.dtype, edges.dtype) == (np.int64,
                                                       np.float32), k
                v = (counts.tolist(), edges.tolist())
            got[k] = v
        out.append((got, step))
    return out


# -- the logger -----------------------------------------------------------------


def test_wandb_mirror_matches_the_jax_logger(tmp_path, monkeypatch):
    """The same records through both loggers, each with its stub: the same
    ``init`` kwargs, ``log`` calls (keys, steps, values; histograms'
    counts and edges, a module with no finite value left out), the same
    JSONL lines (``frame`` included, never mirrored) and one ``finish``.
    The port's logger makes its missing results dir as the JAX one does."""
    rng = np.random.default_rng(0)
    tree = {"encoder": {"b": rng.normal(size=7).astype(np.float32),
                        "w": rng.normal(size=(4, 8)).astype(np.float32)},
            "reward_model": {"w": np.full((3, 3), np.nan, np.float32)},
            "transition_model": {"w": rng.uniform(-2, 5, 40).astype(
                np.float32)}}
    kwargs = {"project": "p", "name": "n", "tags": ["t"]}
    stubs, rows = [], []
    for pkg in ("jax", "port"):
        stub = _make_stub_wandb()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        out = str(tmp_path / pkg / "new")
        if pkg == "jax":
            lg = jmetrics.MetricLogger(out, use_wandb=True,
                                       wandb_kwargs=kwargs)
            hist = lambda t, s, p: lg.log_histograms(t, s, p)   # noqa: E731
            close = lg.finish
        else:
            lg = pmetrics.MetricLogger(out, use_wandb=True,
                                       wandb_kwargs=kwargs)
            hist = lambda t, s, p: lg.log_histograms(   # noqa: E731
                {m: [torch.from_numpy(x) for x in jax.tree_util.tree_leaves(
                    sub)] for m, sub in t.items()}, s, p)
            close = lg.close
        lg.log({"loss": 1.5, "kl_loss": 0.25}, step=7)
        lg.log_frame_count(7, 50, 50)
        lg.log({"loss": 0.5}, step=8, suffix="validation")
        hist(tree, 8, "params")
        hist({k: v for k, v in tree.items() if k != "reward_model"}, 8,
             "grads")
        close()
        stubs.append(stub)
        rows.append([{k: v for k, v in r.items() if k != "time"}
                     for r in _lines(out)])
    jax_stub, port_stub = stubs
    assert port_stub.calls["init"] == jax_stub.calls["init"] == [kwargs]
    assert _as_lists(port_stub.calls["log"]) == _as_lists(
        jax_stub.calls["log"])
    assert len(port_stub.calls["log"]) == 4
    assert port_stub.calls["finish"] == jax_stub.calls["finish"] == 1
    assert _key_sequence(rows[1]) == _key_sequence(rows[0])
    assert rows[1][1] == rows[0][1] == {"frame": 7 * 50 * 50, "step": 7}
    assert _as_lists(port_stub.calls["log"]) == [
        (m, s) for m, s in _expected_mirror(rows[1])]


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("fails", ["import", "init"])
def test_wandb_failure_keeps_the_jsonl(tmp_path, monkeypatch, pkg, fails):
    """``import wandb`` or ``wandb.init`` raising leaves the logger on
    JSONL alone in both packages: nothing mirrored, no ``finish``."""
    stub = _make_stub_wandb()
    if fails == "import":
        monkeypatch.setitem(sys.modules, "wandb", None)
    else:
        def boom(**kw):
            raise RuntimeError("no network")

        stub.init = boom
        monkeypatch.setitem(sys.modules, "wandb", stub)
    logger = (jmetrics.MetricLogger if pkg == "jax"
              else pmetrics.MetricLogger)(str(tmp_path), use_wandb=True)
    logger.log({"kl_loss": 1.0}, step=0)
    (logger.finish if pkg == "jax" else logger.close)()
    assert stub.calls == {"init": [], "log": [], "finish": 0}
    assert _lines(tmp_path)[0]["kl_loss/train"] == 1.0


def test_wandb_kwargs_name_runs_as_the_jax_package(tmp_path, monkeypatch):
    """``wandb.init``'s name, project, tags and dir for a new run, a run
    dir resumed under ``results/`` and one resumed outside it, against the
    JAX package's ``setup_experiment`` on the same config."""
    from multimodal_rssm_tpu.io.experiment import setup_experiment

    cwd = str(tmp_path)
    outside = tmp_path / "elsewhere" / "run_7"
    outside.mkdir(parents=True)
    for resume in (None, "inside", str(outside)):
        stub = _make_stub_wandb()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        over = ["main.experiment_name=named", "main.wandb=true",
                "main.tags=[a,b]"]
        if resume == "inside":
            resume = pmetrics.find_latest_run(cwd, "named")
        _, jdir, jlog, _ = setup_experiment(jax_compose(overrides=over), cwd,
                                            resume)
        jlog.finish()
        cfg = compose(overrides=over)
        want = {k: v for k, v in stub.calls["init"][0].items()
                if k != "config"}
        run_dir = jdir if resume is not None else pmetrics.make_run_dir(
            cfg, cwd)
        got = pmetrics.wandb_kwargs(cfg, cwd, run_dir)
        if resume is None:   # the port minted run_1 beside the JAX run_0
            assert want["name"].endswith("/run_0")
            want["name"] = want["name"][:-1] + "1"
            want["dir"] = want["dir"][:-1] + "1"
        assert {k: v for k, v in got.items() if k != "config"} == want
        assert want["project"] == "SingleHoleDrilling"
        assert got["config"] == cfg.to_dict()
    assert want["name"] == "run_7"


# -- the train loop -------------------------------------------------------------


@pytest.fixture(scope="module")
def port_run(data_dir):
    """The port's train CLI for 4 steps (validation and histograms every
    2) with ``main.wandb=true`` and tags, a stub ``wandb`` installed: the
    result and the stub."""
    stub = _make_stub_wandb()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "wandb", stub)
        result = cli_train.main(RUN + _data(data_dir) + [
            "main.wandb=true", "main.tags=[port,cpu]",
            "main.experiment_name=port", "--device", "cpu", "--cwd",
            str(data_dir)])
    return result, stub


def _jax_init_train_state(model, cfg, optimizer, key, example_batch):
    """``trainer.init_train_state`` with flax's init in one jitted program
    (the same draws; op by op it compiles some 370 programs)."""
    observations, actions, _, nonterminals = example_batch
    variables = jax.jit(lambda k, o, a, n: model.init(
        k, o, a, n, k, train=False))(
        key, {k: v[1:] for k, v in observations.items()}, actions[:-1],
        nonterminals[:-1])
    params = variables["params"]
    return jtr.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          batch_stats=variables.get("batch_stats", {}),
                          opt_state=optimizer.init(params))


def test_train_cli_mirrors_every_record_to_wandb(port_run, data_dir):
    """One ``init`` with the JAX package's kwargs (the run's path under
    ``results/`` as its name, the environment as the project, the saved
    config, the tags, the run dir), each JSONL record mirrored at its step
    (histograms as ``Histogram``s of their counts and edges; ``frame``
    lines not), one ``finish``."""
    result, stub = port_run
    run_dir = result["results_dir"]
    with open(os.path.join(run_dir, "hydra_config.yaml")) as f:
        saved = yaml.safe_load(f)
    assert stub.calls["init"] == [{
        "name": f"port/{datetime.date.today()}/run_0",
        "project": "SingleHoleDrilling", "config": saved,
        "tags": ["port", "cpu"], "dir": run_dir}]
    lines = _lines(run_dir)
    assert sum("frame" in r for r in lines) == STEPS - 1
    assert _as_lists(stub.calls["log"]) == _expected_mirror(lines)
    assert stub.calls["finish"] == 1


def test_non_main_rank_logs_nothing(data_dir, monkeypatch):
    """A rank other than 0 keeps its ``NullLogger`` under
    ``main.wandb=true``: no ``wandb.init``, no ``metrics.jsonl``."""
    stub = _make_stub_wandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    monkeypatch.setattr(mesh_lib, "is_main", lambda: False)
    result = cli_train.main(SMALL + _data(data_dir) + [
        f"train.batch_size={B}", f"train.chunk_size={L}",
        "train.train_iteration=1", "train.validation_interval=1",
        "train.experience_size=200", "main.wandb=true",
        "main.experiment_name=not_main", "--device", "cpu", "--cwd",
        str(data_dir)])
    assert stub.calls == {"init": [], "log": [], "finish": 0}
    assert not os.path.exists(os.path.join(result["results_dir"],
                                           "metrics.jsonl"))
    assert np.isfinite(result["metrics"]["loss"])


def test_metrics_key_sequence_matches_the_jax_loop(port_run, data_dir,
                                                    monkeypatch):
    """4 steps of each package's loop, validation and histograms every 2:
    the same sequence of line key sets (train, frame, validation, params
    and grads histograms, ..., the last train line, perf; the JAX core is
    the port's ``transition_model``) and equal ``frame`` values, step x
    batch x chunk."""
    monkeypatch.setattr(jtr, "init_train_state", _jax_init_train_state)
    cfg = jax_compose(overrides=RUN + _data(data_dir) + [
        "main.experiment_name=jax"])
    _, jax_dir = jloop.run(cfg, cwd=str(data_dir))
    jlines, plines = _lines(jax_dir), _lines(port_run[0]["results_dir"])
    assert _key_sequence(plines) == _key_sequence(
        jlines, {"core": "transition_model"})
    frames = [[(r["step"], r["frame"]) for r in lines if "frame" in r]
              for lines in (jlines, plines)]
    assert frames[1] == frames[0] == [(s, s * B * L)
                                      for s in range(1, STEPS)]
    order = [("frame" if "frame" in r else "hist" if "step" in r and any(
        k.endswith("/hist") for k in r) else next(
        k.split("/")[1] for k in r if "/" in k), r["step"]) for r in plines]
    assert order == [("train", 1), ("frame", 1), ("validation", 2),
                     ("hist", 2), ("hist", 2), ("train", 2), ("frame", 2),
                     ("train", 3), ("frame", 3), ("validation", 4),
                     ("hist", 4), ("hist", 4), ("train", 4), ("perf", 4)]


# -- the config tree ------------------------------------------------------------


def _renamed_tree(root, name, top=None):
    """A copy of the port's config tree whose root file is ``name``.yaml,
    ``top`` merged into the root file's own keys."""
    tree = root / f"tree_{name}"
    shutil.copytree(default_config_dir(), tree,
                    ignore=shutil.ignore_patterns("*.json"))
    os.rename(tree / "config.yaml", tree / f"{name}.yaml")
    if top:
        with open(tree / f"{name}.yaml") as f:
            data = yaml.safe_load(f)
        data.update(top)
        with open(tree / f"{name}.yaml", "w") as f:
            yaml.safe_dump(data, f)
    return str(tree)


def test_config_name_composes_the_same_tree_in_both_packages(tmp_path):
    """A tree whose root is ``bridges.yaml``: both packages compose it to
    the same config, which is the packaged tree's; the train CLI's
    ``--config-name`` takes it, and without it the CLI finds no root."""
    tree = _renamed_tree(tmp_path, "bridges")
    over = ["train.batch_size=7", "rssm=unimodal"]
    port = compose(tree, "bridges", over)
    assert port.to_dict() == jax_compose(tree, "bridges", over).to_dict()
    assert port.to_dict() == compose(overrides=over).to_dict()
    parser = cli_train._parser()
    args = parser.parse_args(["--config-dir", tree, "--config-name",
                              "bridges", *over])
    assert cli_train._config(args, parser, None).to_dict() == port.to_dict()
    args = parser.parse_args(["--config-dir", tree, *over])
    with pytest.raises(FileNotFoundError):
        cli_train._config(args, parser, None)


def test_config_name_and_resume_latest_find_the_run(data_dir, tmp_path):
    """A run trained from a renamed root that names its experiment, then
    ``--resume latest`` with the same ``--config-dir`` / ``--config-name``
    and no experiment name on the command line: the run found and
    continued (the look-up composes the renamed root, as JAX
    ``cli/train.py:57`` does)."""
    tree = _renamed_tree(tmp_path, "renamed",
                         {"main": {"experiment_name": "from_root"}})
    flags = ["--config-dir", tree, "--config-name", "renamed", "--device",
             "cpu", "--cwd", str(data_dir)]
    first = cli_train.main(SMALL + _data(data_dir) + [
        f"train.batch_size={B}", f"train.chunk_size={L}",
        "train.train_iteration=1", "train.validation_interval=2",
        "train.checkpoint_interval=1", "train.experience_size=200", *flags])
    assert os.sep + os.path.join("from_root", "") in first["results_dir"]
    second = cli_train.main(["train.train_iteration=2", "--resume", "latest",
                             *flags])
    assert second["results_dir"] == first["results_dir"]
    assert second["start_step"] == 1 and len(second["step_seconds"]) == 1


def test_mrssm_config_dir_picks_the_tree_in_both_packages(tmp_path,
                                                          monkeypatch):
    """``$MRSSM_CONFIG_DIR`` names the tree each package composes when no
    config dir is given: both read the same value from it."""
    tree = _renamed_tree(tmp_path, "config",
                         {"main": {"experiment_name": "from_env"}})
    monkeypatch.setenv("MRSSM_CONFIG_DIR", tree)
    assert default_config_dir() == tree
    port, jx = compose(overrides=["train.seed=3"]), jax_compose(
        overrides=["train.seed=3"])
    assert port.main.experiment_name == jx.main.experiment_name == "from_env"
    assert port.to_dict() == jx.to_dict()
    monkeypatch.delenv("MRSSM_CONFIG_DIR")
    assert compose().main.experiment_name is None


# -- the observation alias ------------------------------------------------------

SHAPES = {"image": (3, 64, 64), "sound": (128, 20)}
ACT = {"cnn": "relu", "dense": "relu", "fusion": "relu"}
EMB = {"image": 64, "sound": 32, "other": 16, "fusion": 64}


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module")
def alias_encoders():
    """Each multimodal encoder over ("image", "sound") in both packages,
    the port's carrying the JAX one's weights (running stats moved off
    their init), and its observations keyed "observation" with an extra
    key."""
    rng = np.random.default_rng(4)
    obs = {"observation": rng.uniform(-.5, .5, (3, 64, 64, 3)),
           "sound": rng.normal(size=(3, 128, 20)),
           "pose": rng.normal(size=(3, 7))}
    obs = {k: v.astype(np.float32) for k, v in obs.items()}
    names = tuple(SHAPES)
    out = {}
    for kind in ("embedding", "experts"):
        if kind == "embedding":
            jm = jenc.MultimodalEncoder(
                observation_names_enc=names, observation_shapes=SHAPES,
                embedding_size=EMB, activation_function=ACT,
                normalization="BatchNorm")
            port = penc.MultimodalEncoder(names, SHAPES, EMB, ACT,
                                          "BatchNorm")
        else:
            jm = jenc.MultimodalStochasticEncoder(
                observation_names_enc=names, observation_shapes=SHAPES,
                embedding_size=EMB, state_size=8, hidden_size=32,
                activation_function=ACT, normalization="BatchNorm")
            port = penc.MultimodalStochasticEncoder(
                names, SHAPES, EMB, ACT, "BatchNorm", 8, 32)
        canonical = {"image": jnp.asarray(obs["observation"]),
                     "sound": jnp.asarray(obs["sound"])}
        v = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k, o, m=jm: m.init(k, o, False))(jax.random.PRNGKey(0),
                                                    canonical))
        stats = jax.tree_util.tree_map(
            lambda x: (x + rng.uniform(0.1, 0.5, x.shape)).astype(np.float32),
            v["batch_stats"])
        sd = {}
        for name in names:
            sd.update({f"{name}.{k}": t for k, t in codec_state_dict(
                f"{name}_encoder", v["params"][name],
                stats.get(name)).items()})
            if kind == "experts":
                for fc in ("fc1", "fc2"):
                    p = v["params"][f"{name}_head"][fc]
                    sd[f"{name}_head.{fc}.weight"] = _t(p["kernel"].T)
                    sd[f"{name}_head.{fc}.bias"] = _t(p["bias"])
        port.load_state_dict(sd)
        port.eval()
        out[kind] = (jax.jit(lambda v, o, m=jm: m.apply(v, o, False)),
                     {"params": v["params"], "batch_stats": stats}, port)
    return obs, out


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("kind", ["embedding", "experts"])
def test_encoders_resolve_the_observation_alias_as_jax(alias_encoders, kind):
    """An "image" encoder given "observation" (and a key it does not
    encode): the JAX encoder's embeddings (or ``q(st|ot)`` experts) under
    the bridged weights; a missing modality raises the same ``KeyError``
    in both; ``get_obs`` resolves either way."""
    obs, encoders = alias_encoders
    apply, variables, port = encoders[kind]
    want = apply(variables, {k: jnp.asarray(v) for k, v in obs.items()})
    with torch.no_grad():
        got = port({k: _t(v) for k, v in obs.items()})
    assert list(got) == ["image", "sound"]
    want, got = _flat(want), _flat(jax.tree_util.tree_map(
        lambda t: t.numpy(), got))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **EMB_TOL, err_msg=k)
    partial = {"observation": obs["observation"]}
    with pytest.raises(KeyError) as jerr:
        apply(variables, {k: jnp.asarray(v) for k, v in partial.items()})
    with pytest.raises(KeyError) as perr:
        port({k: _t(v) for k, v in partial.items()})
    assert str(perr.value) == str(jerr.value)
    for name, key in (("image", "observation"), ("observation", "image")):
        x = {key: obs["observation"]}
        assert penc.get_obs(x, name) is jenc.get_obs(x, name) is x[key]


def test_world_model_encode_resolves_the_alias():
    """``WorldModel.encode`` on "observation" for its "image" modality,
    with an extra key, equals its encode of the canonical dict."""
    cfg = compose(overrides=SMALL + [
        "rssm.observation_names_enc=[image,sound]",
        "rssm.observation_names_rec=[image,sound]",
        "env.observation_shapes.image=[3,64,64]"])
    model = WorldModel.from_config(cfg).eval()
    rng = np.random.default_rng(2)
    image = _t(rng.uniform(-.5, .5, (2, 3, 64, 64, 3)).astype(np.float32))
    sound = _t(rng.normal(size=(2, 3, 128, 20)).astype(np.float32))
    with torch.no_grad():
        want = model.encode({"image": image, "sound": sound})
        got = model.encode({"observation": image, "sound": sound,
                            "actions": torch.zeros(2, 3, 3)})
        only = model.encode({"observation": image}, names=["image"])
    assert list(got) == ["image", "sound"]
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(only["image"], want["image"])


# -- the console scripts --------------------------------------------------------


def test_console_scripts_name_the_port_clis():
    """Each JAX ``mrssm-*`` script has an ``mrssm-torch-*`` twin whose
    target is the ``main`` of the port's CLI module of the same name, a
    ``command``: from the command line it returns an exit status only
    (``sys.exit(main())``), to a caller its result."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    jax_scripts = {k: v for k, v in scripts.items()
                   if not k.startswith("mrssm-torch-")}
    port_scripts = {k: v for k, v in scripts.items()
                    if k.startswith("mrssm-torch-")}
    assert len(jax_scripts) == len(port_scripts) == 12
    for name, target in jax_scripts.items():
        port_name = name.replace("mrssm-", "mrssm-torch-", 1)
        assert port_scripts[port_name] == target.replace(
            "multimodal_rssm_tpu.", "multimodal_rssm_torch.", 1)
        module, attr = port_scripts[port_name].split(":")
        main = getattr(importlib.import_module(module), attr)
        assert attr == "main" and callable(main)
        assert main.__wrapped__.__module__ == module
    entry = command(lambda argv: {"run_dir": "x"})
    assert entry(None) is None and entry([]) == {"run_dir": "x"}
    assert command(lambda argv: 3)(None) == 3
