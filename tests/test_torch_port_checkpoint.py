"""PyTorch port, the training run's persistence: checkpoints (round trip,
atomic writes, pruning, the asynchronous writer), ``train.model_path``
(a reference ``.pth`` written by the JAX package, a port ``.pt``, and what
raises), and resume / preemption through the train CLI.

The ``.pth`` case is exact: the loaded ``state_dict`` equals
``state_dict_from_jax`` of the same JAX variables, tensor for tensor.
"""

import functools
import glob
import json
import os
import re
import signal

import jax
import numpy as np
import pytest
import torch

from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.io import checkpoint as jax_ckpt
from multimodal_rssm_tpu.io.torch_export import save_reference_checkpoint
from multimodal_rssm_tpu.models.world_model import WorldModel as JaxWorldModel

from multimodal_rssm_torch.cli import train as cli_train
from multimodal_rssm_torch.core.config import compose
from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset
from multimodal_rssm_torch.io import checkpoint as ckpt
from multimodal_rssm_torch.io.jax_weights import state_dict_from_jax
from multimodal_rssm_torch.models.world_model import WorldModel, init_parameters
from multimodal_rssm_torch.train import loop
from multimodal_rssm_torch.train import trainer as tr

SMALL = ["rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
         "rssm.embedding_size.image=64", "rssm.embedding_size.sound=32",
         "rssm.embedding_size.fusion=64", "rssm.embedding_size.other=16",
         "train.use_amp=False"]
SHAPES = {"image_horizon": [3, 64, 64], "sound": [128, 20]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _state(schedule=3, seed=0):
    """A port model (norm stats moved off their init), Adam with its
    warm-up, two steps of random gradients, and a generator."""
    cfg = compose(overrides=SMALL + [f"rssm.learning_rate_schedule={schedule}"])
    model = WorldModel.from_config(cfg)
    init_parameters(model, torch.Generator().manual_seed(seed))
    opt, sched = tr.build_optimizer(cfg, model)
    g = torch.Generator().manual_seed(seed + 1)
    _steps(model, opt, sched, g, 2)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.add_(torch.rand(buf.shape, generator=g))
    return model, opt, sched, g


def _steps(model, opt, sched, g, n):
    for _ in range(n):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
        if sched is not None:
            sched.step()


def _same(a, b):
    """Equal nested state: tensors bit-equal, everything else ==."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _fresh(schedule=3):
    return _state(schedule, seed=11)[:3]


# -- files ----------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["sync", "async"])
def test_checkpoint_round_trip(writer, tmp_path):
    """Model (running stats included), Adam's moments and step count, the
    LR schedule and the generator come back bit-equal, and the next step
    from the restored state equals the next step from the original."""
    model, opt, sched, g = _state()
    extra = {"generator": g.get_state()}
    if writer == "sync":
        path = ckpt.save_checkpoint(str(tmp_path), 2, model, opt, sched, extra)
    else:
        saver = ckpt.AsyncCheckpointer()
        saver.save(str(tmp_path), 2, model, opt, sched, extra)
        path = saver.wait()
    assert os.listdir(tmp_path) == ["models_2.pt"]   # no .tmp left behind
    m2, o2, s2 = _fresh()
    step, got_extra = ckpt.load_checkpoint(path, m2, o2, s2)
    assert step == 2
    assert _same(m2.state_dict(), model.state_dict())
    assert _same(o2.state_dict(), opt.state_dict())
    assert o2.state_dict()["state"][0]["step"] == 2
    assert _same(s2.state_dict(), sched.state_dict())
    g2 = torch.Generator().set_state(got_extra["generator"])
    _steps(model, opt, sched, g, 1)
    _steps(m2, o2, s2, g2, 1)
    assert _same(m2.state_dict(), model.state_dict())


def test_load_checkpoint_is_strict(tmp_path):
    model, opt, sched, _ = _state()
    path = ckpt.save_checkpoint(str(tmp_path), 1, model, opt, sched)
    other = WorldModel.from_config(compose(overrides=SMALL[1:]))  # belief 200
    with pytest.raises(RuntimeError):
        ckpt.load_checkpoint(path, other)
    m2, o2, _ = _fresh(schedule=0)
    with pytest.raises(ValueError, match="LR schedule"):
        ckpt.load_checkpoint(path, m2, o2, None)


def test_async_snapshot_is_isolated_from_later_steps(tmp_path):
    """The optimizer updates parameters in place; the file holds the state
    at ``save``, not after the steps that follow it."""
    model, opt, sched, g = _state()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path), 2, model, opt, sched)
    _steps(model, opt, sched, g, 3)
    path = saver.wait()
    m2, o2, s2 = _fresh()
    ckpt.load_checkpoint(path, m2, o2, s2)
    assert _same(m2.state_dict(), want)
    assert not _same(model.state_dict(), want)


def test_async_writer_error_surfaces_on_wait(tmp_path):
    model, opt, sched, _ = _state()
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(blocker / "run"), 1, model, opt, sched)
    with pytest.raises(OSError):
        saver.wait()
    assert saver.wait() is None      # raised once


@pytest.mark.parametrize("keep", [0, 1, 2, 5])
def test_prune_and_latest_pick_what_jax_picks(keep, tmp_path):
    steps = [30, 1, 10, 2, 100]
    picks = {}
    for name, ext, mod in (("jax", "msgpack", jax_ckpt), ("port", "pt", ckpt)):
        d = tmp_path / name
        d.mkdir()
        for s in steps:
            (d / f"models_{s}.{ext}").write_text("")
        (d / f"models_7.{ext}.tmp").write_text("")
        (d / f"models_x.{ext}").write_text("")
        latest = os.path.basename(mod.latest_checkpoint(str(d)))
        deleted = sorted(os.path.basename(p).split(".")[0]
                         for p in mod.prune_checkpoints(str(d), keep))
        left = sorted(p.split(".")[0] for p in os.listdir(d)
                      if re.fullmatch(rf"models_\d+\.{ext}", p))
        picks[name] = (latest.split(".")[0], deleted, left)
    assert picks["port"] == picks["jax"]
    assert picks["port"][0] == "models_100"
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    assert ckpt.restore_or_none(str(tmp_path / "none"), None) is None


# -- train.model_path ---------------------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt_cli")
    write_synthetic_dataset(str(path / "train"), 2, 30, SHAPES)
    write_synthetic_dataset(str(path / "val"), 1, 30, SHAPES, seed=9)
    return path


def _args(data_dir, *extra):
    return SMALL + [
        f"train.train_data_path=[{data_dir}/train]",
        f"train.validation_data_path=[{data_dir}/val]",
        "train.batch_size=2", "train.chunk_size=4",
        "train.validation_interval=2", "train.experience_size=200",
        *extra, "--device", "cpu", "--cwd", str(data_dir)]


def test_model_path_loads_a_jax_written_reference_pth(data_dir):
    """A ``models_{itr}.pth`` from the JAX package's exporter starts the
    port's run: the model's state_dict equals ``state_dict_from_jax`` of
    the same variables, running stats included."""
    jm = JaxWorldModel.from_config(jax_compose(overrides=SMALL + [
        "rssm.remat=false"]))
    rng = np.random.default_rng(0)
    T, B = 3, 2
    obs = {"image_horizon": rng.uniform(-.5, .5, (T, B, 64, 64, 3)).astype(
        np.float32), "sound": rng.normal(size=(T, B, 128, 20)).astype(
        np.float32)}
    act = rng.normal(size=(T, B, 3)).astype(np.float32)
    init = jax.jit(functools.partial(jm.init, train=False))
    variables = jax.tree_util.tree_map(np.asarray, init(
        jax.random.PRNGKey(3), obs, act, None, None))
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda x: (x + rng.uniform(0.1, 0.5, x.shape)).astype(np.float32),
        variables["batch_stats"])
    save_reference_checkpoint(str(data_dir / "models_100.pth"), jm, variables)
    result = cli_train.main(_args(data_dir, "train.train_iteration=0",
                                  "train.model_path=models_100.pth",
                                  "main.experiment_name=pth"))
    want = state_dict_from_jax(variables["params"], variables["batch_stats"])
    got = result["model"].state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_model_path_loads_a_port_checkpoint(data_dir, tmp_path):
    cfg = compose(overrides=SMALL)
    model, opt, sched, _ = _state(schedule=0)
    path = ckpt.save_checkpoint(str(tmp_path), 9, model, opt, sched)
    cfg.train.model_path = path
    m2, o2, _ = _fresh(schedule=0)
    loop.load_model_path(cfg, ".", m2, o2, None)
    assert _same(m2.state_dict(), model.state_dict())
    assert _same(o2.state_dict(), opt.state_dict())


@pytest.mark.parametrize("name,error,match", [
    ("models_5.msgpack", ValueError, "not a JAX package checkpoint"),
    ("missing.pth", FileNotFoundError, "does not exist"),
    ("weights.npz", ValueError, "not a .pth, .pt or .msgpack")])
def test_model_path_raises_on_what_it_cannot_load(name, error, match,
                                                  tmp_path):
    if name != "missing.pth":
        (tmp_path / name).write_bytes(b"\0")
    cfg = compose(overrides=SMALL + [f"train.model_path={name}"])
    model, opt, sched = _fresh()
    with pytest.raises(error, match=match):
        loop.load_model_path(cfg, str(tmp_path), model, opt, sched)


def test_synchronous_cadence_checkpoints_raise(data_dir):
    with pytest.raises(ValueError, match="async_checkpoint=false"):
        cli_train.main(_args(data_dir, "train.train_iteration=1",
                             "train.async_checkpoint=false"))


@pytest.mark.parametrize("override,match", [
    ("train.mesh.data=4", "item 14"),
    ("train.mesh.model=2", "item 14")])
def test_unported_options_raise(data_dir, override, match):
    """A mesh of more than one device (multi-GPU training, not ported);
    ``train.histogram_interval`` and ``train.profile_dir`` no longer raise
    (tests/test_torch_port_bridges.py)."""
    with pytest.raises(NotImplementedError, match=match):
        cli_train.main(_args(data_dir, "train.train_iteration=1", override))


# -- resume and preemption through the CLI ---------------------------------------------


def _logged_steps(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r["step"] for r in map(json.loads, f) if "loss/train" in r]


def _checkpoint_steps(run_dir):
    return sorted(int(os.path.basename(p)[7:-3])
                  for p in glob.glob(os.path.join(run_dir, "models_*.pt")))


@pytest.mark.parametrize("how", ["run dir", "latest"])
def test_cli_resume_continues_the_run(data_dir, how):
    """4 steps with a checkpoint every 2, then ``--resume`` to 6: the
    second process starts at step 5 and logs only steps 5 and 6."""
    name = f"resume_{how.replace(' ', '_')}"
    first = cli_train.main(_args(data_dir, "train.train_iteration=4",
                                 "train.checkpoint_interval=2",
                                 f"main.experiment_name={name}"))
    run_dir = first["results_dir"]
    assert first["start_step"] == 0 and _checkpoint_steps(run_dir) == [2, 4]
    target = run_dir if how == "run dir" else "latest"
    extra = [] if how == "run dir" else [f"main.experiment_name={name}"]
    second = cli_train.main(["train.train_iteration=6", *extra, "--resume",
                             target, "--device", "cpu", "--cwd",
                             str(data_dir)])
    assert second["results_dir"] == run_dir and second["start_step"] == 4
    assert len(second["step_seconds"]) == 2
    assert _logged_steps(run_dir) == [1, 2, 3, 4, 5, 6]
    assert _checkpoint_steps(run_dir) == [2, 4, 6]


def test_cli_keep_checkpoints_keeps_the_newest(data_dir):
    """Cadence saves, each write followed by the pruning."""
    result = cli_train.main(_args(data_dir, "train.train_iteration=3",
                                  "train.checkpoint_interval=1",
                                  "train.keep_checkpoints=1",
                                  "main.experiment_name=keep"))
    assert _checkpoint_steps(result["results_dir"]) == [3]


def _logged(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [(r["step"], {k: v for k, v in r.items() if k != "time"})
                for r in map(json.loads, f) if "loss/train" in r
                or "loss/validation" in r]


@pytest.mark.parametrize("mode", ["auto", "stream", "false"])
def test_resume_continues_the_draws_of_an_uninterrupted_run(data_dir, mode):
    """2 steps, then ``--resume`` to 5, against 5 steps in one run on each
    feed: the same train and validation metrics at steps 3-5 and the same
    model at the end, bit for bit.  The checkpoint restores the buffer's,
    the validation buffer's and the augmentation's NumPy generators, and
    on the stream its generator and working set, beside the torch one."""
    # noise scales drawn per batch: the augmentation generator matters
    feed = ["train.stream_segment_len=16", f"train.device_replay={mode}",
            "train.augmentation.noise_scales=[0.0,0.05,0.1]",
            *(["train.replay_budget_gb=1e-5"] if mode == "stream" else [])]
    straight = cli_train.main(_args(data_dir, *feed, "train.train_iteration=5",
                                    f"main.experiment_name=straight_{mode}"))
    first = cli_train.main(_args(data_dir, *feed, "train.train_iteration=2",
                                 "train.checkpoint_interval=2",
                                 f"main.experiment_name=cut_{mode}"))
    resumed = cli_train.main(["train.train_iteration=5", "--resume",
                              first["results_dir"], "--device", "cpu",
                              "--cwd", str(data_dir)])
    assert resumed["start_step"] == 2 and resumed["feed"] == straight["feed"]
    want = _logged(straight["results_dir"])
    assert _logged(first["results_dir"]) == want
    assert [s for s, _ in want] == [1, 2, 2, 3, 4, 4, 5]
    assert _same(resumed["model"].state_dict(), straight["model"].state_dict())


def test_sigterm_checkpoints_the_step_reached_and_resumes(data_dir,
                                                          monkeypatch):
    """SIGTERM raised on the loop's thread during step 3 of 6: the run
    stops after it, writes models_3.pt (no cadence checkpoint), and the
    resumed run starts at step 4."""
    make = tr.make_device_resident_steps

    def with_sigterm(*args, **kwargs):
        train_step, eval_step = make(*args, **kwargs)
        calls = []

        def step(*a):
            calls.append(1)
            if len(calls) == 3:
                # the loop's handler is installed: a real signal, no kill
                assert signal.getsignal(signal.SIGTERM) not in (
                    signal.SIG_DFL, None)
                signal.raise_signal(signal.SIGTERM)
            return train_step(*a)

        return step, eval_step

    monkeypatch.setattr(tr, "make_device_resident_steps", with_sigterm)
    first = cli_train.main(_args(data_dir, "train.train_iteration=6",
                                 "main.experiment_name=preempt"))
    monkeypatch.undo()
    run_dir = first["results_dir"]
    assert len(first["step_seconds"]) == 3
    assert _checkpoint_steps(run_dir) == [3]
    second = cli_train.main(["--resume", run_dir, "--device", "cpu",
                             "--cwd", str(data_dir)])
    assert second["start_step"] == 3
    assert _logged_steps(run_dir) == [1, 2, 3, 4, 5, 6]
