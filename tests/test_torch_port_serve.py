"""PyTorch port, serving: the ``torch.export`` artifacts (``io/export.py``),
the key -> noise map (``ops/keyed_noise.py``), the npz HTTP server
(``io/serve.py``) and their CLIs, held against the eager port and against
the JAX package's ``io/export.py`` / ``io/serve.py`` at the
``bench.py --small`` widths in float32 on the CPU, on weights carried over
by ``state_dict_from_jax`` / ``policy_state_dict_from_jax``.

The artifacts compute what the eager port computes; the same key draws
other noise in the two packages (Philox against threefry), so the
stochastic steps are held in two links:

1. each artifact, saved and loaded back, against the eager port given the
   key's noise (``io/export.agent_noise`` / ``cem_noise``): rtol 1e-6,
   atol 1e-6;
2. the eager port against the JAX package's exported artifact on the same
   weights and raw frame, given the noise JAX draws from its key
   (``jax.random.normal(key, (100, B, A))`` for the actor; the planner's
   key splits, ``test_torch_port_control._jax_cem``): the filtered belief
   and posterior mean at ``test_torch_port_eval.py``'s one-step
   tolerance (rtol 1e-5, atol 5e-5), the actions rtol 1e-5, atol 1e-5
   on JAX's filtered state (the mode-seeking action's float32 ties taken
   on JAX's side, as in ``test_torch_port_control.py``).

``filter_step`` and ``decode`` need no noise: the port's artifacts against
JAX's artifacts on the same frame, atol 1e-5 (float32).
"""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rssm_tpu.io import export as jex

from multimodal_rssm_torch.io import export as ex
from multimodal_rssm_torch.io import serve as sv
from multimodal_rssm_torch.models import policy as pol
from multimodal_rssm_torch.ops import keyed_noise
from multimodal_rssm_torch.train import planner as plan_mod
from tests.test_torch_port_control import (  # noqa: F401  (fixtures)
    PLANNER, _configs, _heads, _jax_cem, jax_side_modes, world)
from torch_port_tmp import _remove_module_tmp  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, A, HB, S = 2, 3, 64, 16
EXACT = dict(rtol=1e-6, atol=1e-6)
HEAD = dict(rtol=1e-5, atol=1e-5)
FILTER = dict(rtol=1e-5, atol=5e-5)     # test_torch_port_eval's ONE
JAX_ARTIFACT = dict(rtol=0, atol=1e-5)
ARTIFACTS = ("filter_step", "decode", "agent_step", "plan_step")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _np(x):
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def _raw_frame(cfg, seed=0):
    """One raw observation frame per encoded modality (uint8 NHWC images,
    float32 otherwise), as NumPy."""
    rng = np.random.default_rng(seed)
    obs = {}
    for name in cfg.rssm.observation_names_enc:
        shape = tuple(cfg.env.observation_shapes[name])
        if "image" in name:
            c, h, w = shape
            obs[name] = rng.integers(0, 256, (B, h, w, c), dtype=np.uint8)
        else:
            obs[name] = rng.normal(size=(B, *shape)).astype(np.float32)
    return obs


def _step_arrays(cfg, seed=0, key=(0, 3)):
    """The step artifacts' inputs as NumPy: a nonzero carry, a frame and a
    uint32[2] key."""
    rng = np.random.default_rng(100 + seed)
    return {"h": rng.normal(size=(B, HB)).astype(np.float32),
            "s": rng.normal(size=(B, S)).astype(np.float32),
            "action": rng.uniform(-1, 1, (B, A)).astype(np.float32),
            "obs": _raw_frame(cfg, seed),
            "nonterminal": np.ones((B, 1), np.float32),
            "key": np.asarray(key, np.uint32)}


def _torch_args(arrays, names=ex.STEP_ARGS):
    def t(v):
        v = v.astype(np.int64) if v.dtype == np.uint32 else v
        return torch.from_numpy(np.array(v, copy=True))
    return tuple({k: t(x) for k, x in arrays[n].items()}
                 if isinstance(arrays[n], dict) else t(arrays[n])
                 for n in names)


def _flat(tree):
    return sv.flatten_tree(tree)


@pytest.fixture(scope="module")
def setup(world, tmp_path_factory):
    """The port's four artifacts exported from the ``world`` weights (and
    an actor on JAX's initial actor weights) at batch 2, saved into one
    directory, plus everything to call the eager port."""
    jcfg, cfg = _configs(PLANNER)
    heads, bstate = _heads(jcfg, cfg)
    port = world["port"].eval()
    out = tmp_path_factory.mktemp("artifacts")
    paths = ex.export_run(cfg, port, str(out), B, actor=bstate.actor,
                          plan=True)
    return {"jcfg": jcfg, "cfg": cfg, "heads": heads, "actor": bstate.actor,
            "port": port, "dir": str(out), "paths": paths}


def _eager(setup, name, arrays):
    """The eager port's outputs for one artifact call, the key's noise
    drawn by ``io/export``'s own map."""
    cfg, port, actor = setup["cfg"], setup["port"], setup["actor"]
    if name == "decode":
        h, s = _torch_args(arrays, ex.DECODE_ARGS)
        with torch.no_grad():
            out = port.decode(h[None], s[None])
        return {k: {"loc": v["loc"]} for k, v in out.items()}
    h, s, action, obs, nt, key = _torch_args(arrays)
    obs = ex.normalize_obs(obs, int(cfg.env.bit_depth))
    with torch.no_grad():
        states = port.filter_step(h, s, action, obs, nt)
        if name == "filter_step":
            return states
        h2, s2 = states["beliefs"], states["posterior_means"]
        if name == "agent_step":
            eps = ex.agent_noise(key, B, A)
            return h2, s2, actor(h2, s2, None, True, eps)
        plan = plan_mod.make_cem_planner(port, cfg)
        return h2, s2, plan(h2, s2, noise=ex.cem_noise(port, cfg, key, B))


# -- the key -> noise map ------------------------------------------------------


def test_keyed_noise_is_deterministic_and_draws_differ():
    key = torch.tensor([7, 2 ** 32 - 1])
    a = keyed_noise.normal(key, (1000,), 3)
    torch.testing.assert_close(a, keyed_noise.normal(key.clone(), (1000,), 3),
                               rtol=0, atol=0)
    # another stream, another key word, a shape's prefix
    for other in (keyed_noise.normal(key, (1000,), 4),
                  keyed_noise.normal(torch.tensor([8, 2 ** 32 - 1]),
                                     (1000,), 3),
                  keyed_noise.normal(torch.tensor([7, 0]), (1000,), 3)):
        assert float(torch.corrcoef(torch.stack([a, other]))[0, 1]) < 0.1
    torch.testing.assert_close(keyed_noise.normal(key, (10,), 3), a[:10],
                               rtol=0, atol=0)
    u = keyed_noise.uniform(key, (4096,), 0)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0


@pytest.mark.parametrize("dist", ["normal", "gumbel", "uniform"])
def test_keyed_noise_moments(dist):
    """Mean and variance of 10^5 draws within 5 sigma of the
    distribution's (N(0, 1); standard Gumbel: mean Euler's gamma, variance
    pi^2 / 6; U(0, 1)); the normals' neighbours uncorrelated too."""
    n = 100_000
    x = getattr(keyed_noise, dist)(torch.tensor([123, 456]), (n,), 1
                                   ).double()
    mean, var = {"normal": (0.0, 1.0),
                 "gumbel": (0.5772156649, np.pi ** 2 / 6),
                 "uniform": (0.5, 1 / 12)}[dist]
    kurt = {"normal": 3.0, "gumbel": 5.4, "uniform": 1.8}[dist]
    assert abs(float(x.mean()) - mean) < 5 * np.sqrt(var / n)
    assert abs(float(x.var()) - var) < 5 * var * np.sqrt((kurt - 1) / n)
    if dist == "normal":
        r = float(torch.corrcoef(torch.stack([x[:-1], x[1:]]))[0, 1])
        assert abs(r) < 5 / np.sqrt(n)


# -- the artifacts against the eager port --------------------------------------


@pytest.mark.parametrize("name", ARTIFACTS)
def test_artifact_roundtrip_matches_eager_port(setup, name):
    """save -> load -> call reproduces the eager port on the same inputs
    (the stochastic steps from the key's own noise), float32, its
    description in the file."""
    path = setup["paths"][name]
    assert path.endswith(".pt2") and os.path.getsize(path) > 0
    fn, meta = ex.load_exported(path)
    assert meta["kind"] == name and meta["device"] == "cpu"
    assert meta["compute_dtype"] == "float32" and meta["batch_size"] == B
    arrays = _step_arrays(setup["cfg"], seed=1, key=(5, 2 ** 31 + 9))
    names = ex.DECODE_ARGS if name == "decode" else ex.STEP_ARGS
    with torch.no_grad():
        got = _flat(fn(*_torch_args(arrays, names)))
    want = _flat(_eager(setup, name, arrays))
    assert set(got) == set(want) == set(meta["outputs"])
    for k, w in want.items():
        assert got[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], w, err_msg=f"{name}/{k}", **EXACT)
    if name in ("agent_step", "plan_step"):
        assert np.abs(got["2"]).max() <= 1.0


def test_reexport_gives_bit_equal_outputs(setup, tmp_path):
    """A second export of the same weights computes the same bits (the
    norms read constants in eval mode)."""
    path = ex.save_exported(
        ex.export_filter_step(setup["cfg"], setup["port"], B),
        str(tmp_path / "again.pt2"))
    arrays = _step_arrays(setup["cfg"], seed=2)
    args = _torch_args(arrays)
    with torch.no_grad():
        a = _flat(ex.load_exported(path)[0](*args))
        b = _flat(ex.load_exported(setup["paths"]["filter_step"])[0](*args))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_artifact_streaming_carry(setup):
    """Three frames through the filter_step artifact, carrying its own
    beliefs and posterior states, equal the eager filter frame by frame;
    the state moves."""
    fn, _ = ex.load_exported(setup["paths"]["filter_step"])
    arrays = _step_arrays(setup["cfg"])
    carry = {"h": np.zeros((B, HB), np.float32),
             "s": np.zeros((B, S), np.float32)}
    states = []
    for t in range(3):
        arrays.update(_step_arrays(setup["cfg"], seed=10 + t), **carry)
        with torch.no_grad():
            got = _flat(fn(*_torch_args(arrays)))
        want = _flat(_eager(setup, "filter_step", arrays))
        for k in ("beliefs", "posterior_states", "posterior_means"):
            np.testing.assert_allclose(got[k], want[k], **EXACT)
        carry = {"h": got["beliefs"], "s": got["posterior_states"]}
        states.append(got["posterior_states"])
    assert all(np.isfinite(x).all() for x in states)
    assert not np.allclose(states[0], states[2])


def test_load_refuses_an_invisible_or_other_device(setup, monkeypatch):
    path = setup["paths"]["decode"]
    with pytest.raises(ValueError, match="exported for cpu"):
        ex.load_exported(path, device="cuda")
    meta = sv.read_meta(path)
    monkeypatch.setattr(sv, "read_meta", lambda p: {**meta, "device": "cuda"})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="exported for cuda"):
        sv.load_exported(path)


# -- the port against the JAX package ------------------------------------------


@pytest.fixture(scope="module")
def jax_artifacts(world, setup, tmp_path_factory):
    """The JAX package's four artifacts on the same weights, batch 2,
    through its own save / load."""
    jcfg, jm, wm = setup["jcfg"], world["jm"], world["variables"]
    actor, _, _, _, jstate = setup["heads"]
    out = tmp_path_factory.mktemp("jax_artifacts")
    made = {
        "filter_step": jex.export_filter_step(jcfg, jm, wm, batch_size=B),
        "decode": jex.export_decode(jcfg, jm, wm, batch_size=B),
        "agent_step": jex.export_agent_step(jcfg, jm, actor, wm,
                                            jstate.actor_params, B),
        "plan_step": jex.export_plan_step(jcfg, jm, wm, batch_size=B),
    }
    return {k: jex.load_exported(jex.save_exported(
        v, str(out / f"{k}.jaxexport"))) for k, v in made.items()}


def _jax_call(jax_artifacts, name, arrays):
    if name == "decode":
        return jax_artifacts[name].call(arrays["h"], arrays["s"])
    return jax_artifacts[name].call(
        arrays["h"], arrays["s"], arrays["action"],
        {k: jnp.asarray(v) for k, v in arrays["obs"].items()},
        arrays["nonterminal"], arrays["key"])


@pytest.mark.parametrize("name", ["filter_step", "decode"])
def test_filter_and_decode_match_jax_artifacts(setup, jax_artifacts, name):
    """The port's artifact against the JAX package's on the same weights
    and raw frame: every output JAX's has, atol 1e-5, float32."""
    arrays = _step_arrays(setup["cfg"], seed=3)
    fn, _ = ex.load_exported(setup["paths"][name])
    names = ex.DECODE_ARGS if name == "decode" else ex.STEP_ARGS
    with torch.no_grad():
        got = _flat(fn(*_torch_args(arrays, names)))
    want = {k: v for k, v in _flat(jax.tree_util.tree_map(
        np.asarray, _jax_call(jax_artifacts, name, arrays))).items()
        if not k.endswith(".scale")}
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, err_msg=k, **JAX_ARTIFACT)


@pytest.mark.parametrize("name", ["agent_step", "plan_step"])
def test_controller_steps_match_jax_on_its_noise(world, setup, jax_artifacts,
                                                 name, jax_side_modes):
    """Link 2: the JAX package's artifact against the eager port given
    the noise JAX draws from the same key: the filtered carry at the
    filter's tolerance, the action (from JAX's filtered state) at the
    heads'."""
    arrays = _step_arrays(setup["cfg"], seed=4, key=(0, 11))
    h2, s2, want = (np.asarray(x) for x in
                    _jax_call(jax_artifacts, name, arrays))
    eager = _eager(setup, "filter_step", arrays)
    np.testing.assert_allclose(_np(eager["beliefs"]), h2, **FILTER)
    np.testing.assert_allclose(_np(eager["posterior_means"]), s2, **FILTER)
    key = jnp.asarray(arrays["key"])
    th, ts = torch.from_numpy(h2.copy()), torch.from_numpy(s2.copy())
    with torch.no_grad():
        if name == "agent_step":
            eps = torch.from_numpy(np.array(jax.random.normal(
                key, (pol.MODE_SAMPLES, B, A))))
            got = setup["actor"](th, ts, None, True, eps)
        else:
            _, _, a_eps, s_eps = _jax_cem(world["jm"], world["variables"],
                                          setup["jcfg"], jnp.asarray(h2),
                                          jnp.asarray(s2), key)
            plan = plan_mod.make_cem_planner(setup["port"], setup["cfg"])
            got = plan(th, ts, noise=(a_eps, s_eps))
    np.testing.assert_allclose(_np(got), want, **HEAD)


@pytest.fixture(scope="module")
def amp_artifacts(world, tmp_path_factory):
    """``cli/export_model.py`` on a ``train.use_amp=true`` run whose
    checkpoint holds the ``world`` weights: {name: (callable, meta)}."""
    from multimodal_rssm_torch.cli import export_model
    from multimodal_rssm_torch.core.config import save_config
    from multimodal_rssm_torch.io.checkpoint import save_checkpoint
    from multimodal_rssm_torch.train import trainer as tr

    run = str(tmp_path_factory.mktemp("amp_run"))
    _, cfg = _configs(PLANNER + ["train.use_amp=true"])
    save_config(cfg, os.path.join(run, "hydra_config.yaml"))
    save_checkpoint(run, 1, world["port"],
                    tr.build_optimizer(cfg, world["port"])[0])
    out = os.path.join(run, "exported")
    written = export_model.main(["--run-dir", run, "--out", out,
                                 "--batch-size", str(B), "--device", "cpu"])
    assert set(written) == {"filter_step", "decode"}
    return {k: ex.load_exported(v["path"]) for k, v in written.items()}


@pytest.mark.parametrize("name", ["filter_step", "decode"])
def test_amp_run_artifacts_are_float32_and_match_jax(setup, jax_artifacts,
                                                     amp_artifacts, name):
    """A ``train.use_amp=true`` run's artifacts compute in float32, as the
    JAX package's ``export_model`` builds its serving model: the meta says
    so, they give what the float32 artifact of the same weights gives,
    bit for bit, and they equal the JAX package's artifacts on the same
    weights and raw frame (``test_filter_and_decode_match_jax_artifacts``'s
    frame) at its float32 tolerance (atol 1e-5)."""
    fn, meta = amp_artifacts[name]
    assert meta["compute_dtype"] == "float32"
    arrays = _step_arrays(setup["cfg"], seed=3)
    names = ex.DECODE_ARGS if name == "decode" else ex.STEP_ARGS
    f32, _ = ex.load_exported(setup["paths"][name])
    with torch.no_grad():
        got = _flat(fn(*_torch_args(arrays, names)))
        same = _flat(f32(*_torch_args(arrays, names)))
    assert set(got) == set(same)
    for k, v in same.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    want = {k: v for k, v in _flat(jax.tree_util.tree_map(
        np.asarray, _jax_call(jax_artifacts, name, arrays))).items()
        if not k.endswith(".scale")}
    assert set(want) <= set(got), sorted(set(want) - set(got))
    for k, w in want.items():
        assert str(got[k].dtype) == "float32", k
        np.testing.assert_allclose(got[k], w, err_msg=k, **JAX_ARTIFACT)


# -- the server ------------------------------------------------------------------


def _post_npz(url, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(
        url, data=buf.getvalue(),
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=120) as r:
        body = r.read()
    with np.load(io.BytesIO(body)) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def served(setup):
    httpd = sv.make_server(setup["dir"], port=0, device="cpu")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def test_flatten_unflatten_roundtrip():
    tree = {"a": np.ones((2,)), "b": {"c": np.zeros((1, 3)),
                                      "d": torch.arange(4)}}
    flat = sv.flatten_tree(tree)
    assert set(flat) == {"a", "b.c", "b.d"}
    assert isinstance(flat["b.d"], np.ndarray)
    back = sv.unflatten_tree(flat)
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])
    np.testing.assert_array_equal(back["b"]["d"], np.arange(4))
    assert sv.flatten_tree((np.ones(1), {"x": np.zeros(2)})).keys() == {
        "0", "1.x"}


def test_healthz_and_info(served):
    with urllib.request.urlopen(served + "/healthz", timeout=30) as r:
        assert json.load(r) == {"status": "ok"}
    with urllib.request.urlopen(served + "/v1/info", timeout=30) as r:
        info = json.load(r)
    assert set(info) == set(ARTIFACTS)
    for name, entry in info.items():
        assert entry["platforms"] == ["cpu"] and entry["device"] == "cpu"
        assert entry["compute_dtype"] == "float32"
        assert entry["arg_names"][0] == "h" and entry["in_avals"]
        assert entry["out_avals"]
    assert "obs.image_horizon: uint8[2, 64, 64, 3]" in info["filter_step"][
        "in_avals"]


def _request(arrays, name):
    if name == "decode":
        return {"h": arrays["h"], "s": arrays["s"]}
    flat = {k: v for k, v in arrays.items() if k != "obs"}
    flat.update({f"obs.{k}": v for k, v in arrays["obs"].items()})
    return flat


@pytest.mark.parametrize("name", ARTIFACTS)
def test_served_call_equals_direct_call(setup, served, name):
    """HTTP round trip == direct artifact call, bit for bit."""
    arrays = _step_arrays(setup["cfg"], seed=5, key=(9, 4))
    out = _post_npz(f"{served}/v1/call/{name}", _request(arrays, name))
    fn, _ = ex.load_exported(setup["paths"][name])
    names = ex.DECODE_ARGS if name == "decode" else ex.STEP_ARGS
    with torch.no_grad():
        ref = _flat(fn(*_torch_args(arrays, names)))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_serve_streaming_carry(setup, served):
    """The stateless protocol carries (belief, state) across calls, equal
    to the direct calls; then decodes the final carry."""
    fn, _ = ex.load_exported(setup["paths"]["filter_step"])
    arrays = _step_arrays(setup["cfg"])
    arrays.update(h=np.zeros((B, HB), np.float32),
                  s=np.zeros((B, S), np.float32))
    direct = dict(arrays)
    for t in range(3):
        frame = _step_arrays(setup["cfg"], seed=20 + t)["obs"]
        arrays["obs"] = direct["obs"] = frame
        out = _post_npz(served + "/v1/call/filter_step",
                        _request(arrays, "filter_step"))
        with torch.no_grad():
            ref = _flat(fn(*_torch_args(direct)))
        np.testing.assert_array_equal(out["posterior_states"],
                                      ref["posterior_states"])
        arrays["h"], arrays["s"] = out["beliefs"], out["posterior_states"]
        direct["h"], direct["s"] = ref["beliefs"], ref["posterior_states"]
    dec = _post_npz(served + "/v1/call/decode",
                    {"h": arrays["h"], "s": arrays["s"]})
    assert {k for k in dec} == {f"{n}.loc" for n in
                                setup["cfg"].rssm.observation_names_rec}
    assert all(np.isfinite(v).all() for v in dec.values())


def test_serve_errors(setup, served):
    def error(url, arrays=None):
        with pytest.raises(urllib.error.HTTPError) as ei:
            if arrays is None:
                urllib.request.urlopen(url, timeout=30)
            else:
                _post_npz(url, arrays)
        return ei.value.code, json.load(ei.value)["error"]

    code, msg = error(served + "/v1/call/nope", {"h": np.zeros(1)})
    assert code == 400 and "unknown artifact" in msg
    code, msg = error(served + "/v1/call/filter_step", {"h": np.zeros(1)})
    assert code == 400 and "missing inputs" in msg and "'key'" in msg
    arrays = _request(_step_arrays(setup["cfg"]), "filter_step")
    arrays["h"] = np.zeros((B + 1, HB), np.float32)
    code, msg = error(served + "/v1/call/filter_step", arrays)
    assert code == 400 and "h: float32[3, 64], expected float32[2, 64]" in msg
    assert error(served + "/v1/what")[0] == 404
    assert error(served + "/v2/call/decode", {"h": np.zeros(1)})[0] == 404


def test_serve_needs_no_model_code(setup):
    """``io/serve.py`` loads and calls the artifacts in a process in which
    no module of the port's models, nor ``io/export``, is imported."""
    code = (
        "import sys, numpy as np\n"
        "from multimodal_rssm_torch.io import serve as sv\n"
        f"store = sv.ArtifactStore({setup['dir']!r}, 'cpu')\n"
        "out = store.call('decode', {'h': np.zeros((2, 64), np.float32), "
        "'s': np.zeros((2, 16), np.float32)})\n"
        "bad = [m for m in sys.modules if m.startswith(("
        "'multimodal_rssm_torch.models', 'multimodal_rssm_torch.rssm', "
        "'multimodal_rssm_torch.train', 'multimodal_rssm_torch.io.export'))]\n"
        "print(sorted(store.artifacts), sorted(out), bad)\n"
        "sys.exit(1 if bad or not out else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "'image_horizon.loc'" in proc.stdout


# -- the CLIs ----------------------------------------------------------------------


@pytest.mark.parametrize("cli", ["export_model", "serve", "quality_gate",
                                 "calibrate_quality_windows"])
def test_clis_raise_without_a_gpu(cli, monkeypatch, tmp_path):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"multimodal_rssm_torch.cli.{cli}")
    argv = {"export_model": ["--run-dir", str(tmp_path)],
            "serve": ["--artifacts", str(tmp_path)],
            "quality_gate": ["--workdir", str(tmp_path)],
            "calibrate_quality_windows": ["--workdir", str(tmp_path)]}[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    assert os.listdir(tmp_path) == []


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A tiny run through the port's CLIs: 2 world-model steps with a
    checkpoint and the reward head, then 1 behavior iteration."""
    from multimodal_rssm_torch.cli import train, train_behavior
    from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset

    root = str(tmp_path_factory.mktemp("cli_run"))
    shapes = {"image_horizon": [3, 64, 64], "sound": [128, 20]}
    write_synthetic_dataset(os.path.join(root, "train"), 2, 30, shapes)
    write_synthetic_dataset(os.path.join(root, "val"), 1, 30, shapes, seed=9)
    tiny = ["rssm.belief_size=64", "rssm.state_size=16",
            "rssm.hidden_size=64", "rssm.embedding_size.image=64",
            "rssm.embedding_size.sound=32", "rssm.embedding_size.fusion=64",
            "rssm.embedding_size.other=16", "train.use_amp=False"]
    result = train.main(tiny + [
        "train.batch_size=2", "train.chunk_size=4", "train.train_iteration=2",
        "train.validation_interval=2", "train.checkpoint_interval=2",
        "train.experience_size=200", "rssm.predict_reward=true",
        f"train.train_data_path=[{root}/train]",
        f"train.validation_data_path=[{root}/val]",
        "--device", "cpu", "--cwd", root])
    run = result["results_dir"]
    train_behavior.main(["--run-dir", run, "--cwd", root, "--device", "cpu",
                         "behavior.train_iteration=1", "behavior.horizon=3"])
    return run


def test_export_model_cli_on_cpu(run_dir, tmp_path):
    """The CLI writes all four artifacts (agent_step from behavior/,
    plan_step with --plan and small planner overrides) and prints their
    paths and sizes; the store serves them."""
    from multimodal_rssm_torch.cli import export_model

    out = str(tmp_path / "exported")
    result = export_model.main([
        "--run-dir", run_dir, "--out", out, "--plan", "--device", "cpu",
        "planner.candidates=20", "planner.top_candidates=4",
        "planner.planning_horizon=3", "planner.optimisation_iters=2"])
    assert set(result) == set(ARTIFACTS)
    for name, entry in result.items():
        assert entry["path"] == os.path.join(out, name + ".pt2")
        assert entry["bytes"] == os.path.getsize(entry["path"]) > 0
    store = sv.ArtifactStore(out, "cpu")
    h = np.zeros((1, 64), np.float32)
    s = np.zeros((1, 16), np.float32)
    frame = {"obs.image_horizon": np.zeros((1, 64, 64, 3), np.uint8),
             "obs.sound": np.zeros((1, 128, 20), np.float32)}
    got = store.call("plan_step", {"h": h, "s": s, "action": np.zeros(
        (1, 3), np.float32), "nonterminal": np.ones((1, 1), np.float32),
        "key": np.asarray([1, 2], np.uint32), **frame})
    assert got["2"].shape == (1, 3) and np.abs(got["2"]).max() <= 1.0


def test_export_model_cli_refuses_plan_without_reward_head(run_dir, tmp_path):
    from multimodal_rssm_torch.cli import export_model

    with pytest.raises(ValueError, match="predict_reward"):
        export_model.main(["--run-dir", run_dir, "--out", str(tmp_path),
                           "--plan", "--device", "cpu",
                           "rssm.predict_reward=false"])
    assert os.listdir(tmp_path) == []


def test_serve_cli_on_cpu(setup):
    """``cli/serve.py --device cpu`` in its own process answers /healthz
    and a call."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "multimodal_rssm_torch.cli.serve",
         "--artifacts", setup["dir"], "--port", str(port), "--device", "cpu"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving artifacts" in line, line
        url = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.load(r) == {"status": "ok"}
        out = _post_npz(url + "/v1/call/decode",
                        {"h": np.zeros((B, HB), np.float32),
                         "s": np.zeros((B, S), np.float32)})
        assert "image_horizon.loc" in out
    finally:
        proc.terminate()
        proc.wait(timeout=30)
