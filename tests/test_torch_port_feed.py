"""PyTorch port, the training run's feed: the native chunk gather, the
threaded episode ingest, the device-resident and streaming replays, the
device budget, the device-resident step, the prefetcher and the feed paths
of the train CLI.

Every comparison with the JAX package is exact (integer gathers and copies
of the same rows, the same NumPy draws).  The device-resident step is held
bit-equal to the host-fed step on the same rows.
"""

import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_rssm_tpu.core.config import compose as jax_compose
from multimodal_rssm_tpu.data import buffer as jax_buffer
from multimodal_rssm_tpu.data import device_buffer as jax_db
from multimodal_rssm_tpu.data import native as jax_native

from multimodal_rssm_torch.cli import train as cli_train
from multimodal_rssm_torch.core.config import compose
from multimodal_rssm_torch.data import buffer as port_buffer
from multimodal_rssm_torch.data import device_buffer as db
from multimodal_rssm_torch.data import native
from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset
from multimodal_rssm_torch.models.world_model import WorldModel, init_parameters
from multimodal_rssm_torch.train import trainer as tr
from multimodal_rssm_torch.train.prefetch import Prefetcher

SMALL = ["rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
         "rssm.embedding_size.image=64", "rssm.embedding_size.sound=32",
         "rssm.embedding_size.fusion=64", "rssm.embedding_size.other=16",
         "train.use_amp=False"]
SHAPES = {"image_horizon": [3, 64, 64], "sound": [128, 20]}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    """Three 30-step episodes in the COBOTTA schema (90 rows)."""
    path = tmp_path_factory.mktemp("episodes")
    write_synthetic_dataset(str(path), 3, 30, SHAPES)
    return str(path)


def _buffers(episodes, seed=3):
    over = ["train.experience_size=200"]
    jD = jax_buffer.build_buffer(jax_compose(overrides=over), seed=seed)
    jD.load_dataset(episodes)
    pD = port_buffer.build_buffer(compose(overrides=over), seed=seed)
    port_buffer.load_dataset(episodes, pD, ".")
    return jD, pD


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# -- the native gather -----------------------------------------------------------


@pytest.mark.parametrize("route", ["native", "plain"])
@pytest.mark.parametrize("rows", ["uint8 images", "float32 rows"])
def test_gather_chunks_matches_jax(route, rows):
    rng = np.random.default_rng(0)
    if rows == "uint8 images":
        src = rng.integers(0, 255, size=(200, 8, 8, 3), dtype=np.uint8)
    else:
        src = rng.normal(size=(50, 6)).astype(np.float32)
    idxs = rng.integers(0, src.shape[0], size=(5, 7))
    fn = native.gather_chunks if route == "native" else native.gather_chunks_plain
    got = fn(src, idxs)
    want = jax_native.gather_chunks(src, idxs)
    assert got.shape == want.shape == (7, 5, *src.shape[1:])
    assert got.dtype == src.dtype
    np.testing.assert_array_equal(got, want)


def test_gather_chunks_into_a_given_array():
    """``out=``: the rows land in the caller's array (the host feed's
    pinned staging batch), equal to the JAX gather; a wrong array raises."""
    rng = np.random.default_rng(1)
    src = rng.integers(0, 255, size=(200, 8, 8, 3), dtype=np.uint8)
    idxs = rng.integers(0, 200, size=(5, 7))
    out = np.full((7, 5, 8, 8, 3), 7, np.uint8)
    assert native.gather_chunks(src, idxs, out=out) is out
    np.testing.assert_array_equal(out, jax_native.gather_chunks(src, idxs))
    for wrong in (np.empty((5, 7, 8, 8, 3), np.uint8),
                  np.empty((7, 5, 8, 8, 3), np.float32),
                  np.empty((5, 7, 8, 8, 3), np.uint8).swapaxes(0, 1)):
        with pytest.raises(ValueError, match="out must be"):
            native.gather_chunks(src, idxs, out=wrong)


@pytest.mark.parametrize("route", ["native", "plain"])
@pytest.mark.parametrize("bad", [-1, 10])
def test_gather_chunks_rejects_out_of_range(route, bad):
    fn = native.gather_chunks if route == "native" else native.gather_chunks_plain
    with pytest.raises(IndexError):
        fn(np.zeros((10, 4), np.float32), np.asarray([[0, bad]]))


@pytest.mark.parametrize("fault", ["broken source", "no compiler"])
def test_native_build_failure_raises(fault, tmp_path, monkeypatch):
    """A failed build raises: nothing falls back to the NumPy gather."""
    src = tmp_path / "gather.cpp"
    src.write_text("this is not C++\n" if fault == "broken source"
                   else open(native.SOURCE).read())
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "out" / "lib.so"))
    if fault == "no compiler":
        monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.build()
    assert not os.path.exists(native.LIBRARY)


# -- ingest ---------------------------------------------------------------------


def test_parallel_load_equals_serial_and_jax(episodes):
    over = compose(overrides=["train.experience_size=200"])
    serial = port_buffer.build_buffer(over)
    serial.load_dataset(episodes, workers=1)
    parallel = port_buffer.build_buffer(over)
    assert parallel.load_workers == 4
    parallel.load_dataset(episodes)
    jD, _ = _buffers(episodes)
    for D in (parallel, jD):
        assert (D.idx, D.full, D.steps, D.episodes) == (90, False, 90, 3)
        for name in serial.observation_names:
            np.testing.assert_array_equal(D.observations[name][:90],
                                          serial.observations[name][:90])
        for key in ("actions", "rewards", "nonterminals"):
            np.testing.assert_array_equal(getattr(D, key)[:90],
                                          getattr(serial, key)[:90])


# -- the device-resident replay ---------------------------------------------------


def test_device_replay_and_gather_batch_match_jax(episodes):
    jD, pD = _buffers(episodes)
    jdev, pdev = jax_db.DeviceReplay(jD), db.DeviceReplay(pD, CPU)
    assert pdev.row_shapes == jdev.row_shapes
    assert set(pdev.arrays) == set(jdev.arrays)
    for k, v in jdev.arrays.items():
        np.testing.assert_array_equal(_np(pdev.arrays[k]), _np(v))
    assert db.DeviceReplay.nbytes(pD) == jax_db.DeviceReplay.nbytes(jD)
    idxs = pD.sample_indices(4, 6)
    want = jax_db.gather_batch(jdev.arrays, jnp.asarray(idxs),
                               jD.observation_names, jdev.row_shapes)
    got = db.gather_batch(pdev.arrays, db.indices_to_device(idxs, CPU),
                          pD.observation_names, pdev.row_shapes)
    for k in want[0]:
        assert got[0][k].is_contiguous()
        np.testing.assert_array_equal(_np(got[0][k]), _np(want[0][k]))
    for w, g in zip(want[1:], got[1:]):
        assert g.is_contiguous()
        np.testing.assert_array_equal(_np(g), _np(w))
    # and the host buffer's own gather of the same rows
    host = pD.gather(idxs)
    np.testing.assert_array_equal(_np(got[0]["image_horizon"]),
                                  host[0]["image_horizon"])
    np.testing.assert_array_equal(_np(got[2]), host[2])


def _stream_budget(D, segments, S):
    used = D.size if D.full else D.idx
    return int(segments * S * jax_db.DeviceReplay.nbytes(D) / used) + 1


def test_streaming_replay_matches_jax(episodes):
    """One seed, budget and segment length: the same working set, five
    index matrices and the arrays after three refreshes."""
    jD, pD = _buffers(episodes)
    S, L = 16, 6
    budget = _stream_budget(jD, 3, S)
    kw = dict(chunk_size=L, budget_bytes=budget, segment_len=S,
              refresh_segments=2, seed=7)
    jdev = jax_db.StreamingDeviceReplay(jD, **kw)
    pdev = db.StreamingDeviceReplay(pD, device=CPU, **kw)
    assert (pdev.W, pdev.S, pdev.n_host_segments) == (jdev.W, jdev.S, 5)
    assert pdev.W == 3
    np.testing.assert_array_equal(pdev.resident, jdev.resident)
    assert pdev.row_shapes == jdev.row_shapes
    for _ in range(5):
        np.testing.assert_array_equal(_np(pdev.sample_indices(4, L)),
                                      _np(jdev.sample_indices(4, L)))
    for _ in range(3):
        assert pdev.refresh() == jdev.refresh()
    np.testing.assert_array_equal(pdev.resident, jdev.resident)
    for k, v in jdev.arrays.items():
        np.testing.assert_array_equal(_np(pdev.arrays[k]), _np(v))


def test_streaming_replay_state_continues_the_working_set(episodes):
    """``state()`` after three refreshes, restored into a replay built from
    the same seed: the same working set and arrays, then the same draws and
    refreshes as the original; another slot count raises."""
    _, pD = _buffers(episodes)
    S, L = 16, 6
    kw = dict(chunk_size=L, budget_bytes=_stream_budget(pD, 3, S),
              segment_len=S, seed=7)
    a = db.StreamingDeviceReplay(pD, device=CPU, **kw)
    for _ in range(3):
        a.refresh()
    b = db.StreamingDeviceReplay(pD, device=CPU, **kw)
    assert not np.array_equal(a.resident, b.resident)
    b.set_state(a.state())
    for _ in range(2):
        np.testing.assert_array_equal(b.resident, a.resident)
        for k, v in a.arrays.items():
            assert torch.equal(b.arrays[k], v), k
        assert torch.equal(b.sample_indices(4, L), a.sample_indices(4, L))
        a.refresh()
        b.refresh()
    small = db.StreamingDeviceReplay(
        pD, device=CPU, **{**kw, "budget_bytes": _stream_budget(pD, 2, S)})
    with pytest.raises(ValueError, match="3 segments cannot continue in 2"):
        small.set_state(a.state())


def test_streaming_replay_refuses_what_jax_refuses(episodes):
    jD, pD = _buffers(episodes)
    for kw in (dict(chunk_size=6, segment_len=50),   # 90 rows < 2 x 50
               dict(chunk_size=20, segment_len=10)):  # segment < chunk
        with pytest.raises(ValueError) as want:
            jax_db.StreamingDeviceReplay(jD, budget_bytes=1 << 20, **kw)
        with pytest.raises(ValueError) as got:
            db.StreamingDeviceReplay(pD, device=CPU, budget_bytes=1 << 20,
                                     **kw)
        assert str(got.value) == str(want.value)


def test_hbm_budget_bytes(monkeypatch):
    monkeypatch.delenv("MRSSM_REPLAY_BUDGET_GB", raising=False)
    assert db.hbm_budget_bytes(CPU) == jax_db.hbm_budget_bytes() == 4 << 30
    gib = 1 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (79 * gib, 80 * gib))
    cuda = torch.device("cuda")
    assert db.hbm_budget_bytes(cuda) == 79 * gib - db._DEFAULT_RESERVE_BYTES
    assert db.hbm_budget_bytes(cuda, reserve_bytes=9 * gib) == 70 * gib
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (30 * gib, 80 * gib))
    assert db.hbm_budget_bytes(cuda) == 2 * gib   # the floor
    monkeypatch.setenv("MRSSM_REPLAY_BUDGET_GB", "0.5")
    assert db.hbm_budget_bytes(cuda) == db.hbm_budget_bytes(CPU) == gib // 2


# -- the device-resident step -------------------------------------------------------


def test_device_resident_step_equals_host_step(episodes):
    """One train step on the same rows, draws and generator seed: the
    device-resident step (gather on the device) gives exactly the host-fed
    step's metrics and parameters."""
    cfg = compose(overrides=SMALL + ["train.experience_size=200",
                                     "train.pallas_normalize=true"])
    D = port_buffer.build_buffer(cfg)
    port_buffer.load_dataset(episodes, D, ".")
    replay = db.DeviceReplay(D, CPU)
    spec = tr.build_aug_spec(D)
    draws = tr.HostAugmentDraws(D, spec, seed=0).draw()
    idxs = D.sample_indices(2, 4)
    out = []
    for feed in ("host", "device"):
        model = WorldModel.from_config(cfg)
        init_parameters(model, torch.Generator().manual_seed(0))
        opt, sched = tr.build_optimizer(cfg, model)
        gen = torch.Generator().manual_seed(5)
        if feed == "host":
            step, _ = tr.make_train_step(model, cfg, opt, sched, spec, CPU)
            metrics = step(port_buffer.to_device(D.gather(idxs), CPU), draws,
                           gen)
        else:
            step, _ = tr.make_device_resident_steps(
                model, cfg, opt, sched, spec, CPU, D.observation_names,
                replay.row_shapes)
            metrics = step(replay.arrays, db.indices_to_device(idxs, CPU),
                           draws, gen)
        out.append((metrics, model.state_dict()))
    (hm, hsd), (dm, dsd) = out
    assert set(hm) == set(dm)
    for k in hm:
        assert torch.equal(hm[k], dm[k]), k
    for k in hsd:
        assert torch.equal(hsd[k], dsd[k]), k


def test_host_batch_feed_draws_and_gathers_as_the_buffer(episodes):
    """The host feed's producer gives the batches ``sample`` gives from a
    twin buffer of the same seed, each with the generator's state after
    its draw."""
    cfg = compose(overrides=["train.experience_size=200"])
    D, twin = port_buffer.build_buffer(cfg, 4), port_buffer.build_buffer(cfg, 4)
    for buf in (D, twin):
        port_buffer.load_dataset(episodes, buf, ".")
    feed = port_buffer.HostBatchFeed(D, 3, 5, CPU)
    for _ in range(3):
        state, (obs, act, rew, nt) = feed()
        wobs, wact, wrew, wnt = port_buffer.to_device(twin.sample(3, 5), CPU)
        assert state == twin.rng.bit_generator.state
        for k in wobs:
            assert torch.equal(obs[k], wobs[k]), k
        for got, want in ((act, wact), (rew, wrew), (nt, wnt)):
            assert torch.equal(got, want)


# -- the prefetcher ------------------------------------------------------------------


def test_prefetcher_keeps_order_and_depth():
    produced = []
    lock = threading.Lock()

    def produce():
        with lock:
            produced.append(len(produced))
            return produced[-1]

    with Prefetcher(produce, depth=2) as pf:
        deadline = time.monotonic() + 5
        while len(produced) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        # two queued and one waiting to be queued: never more
        assert len(produced) == 3
        assert [pf.get() for _ in range(5)] == [0, 1, 2, 3, 4]
    assert not pf._thread.is_alive()


def test_prefetcher_raises_the_workers_error_and_closes():
    calls = []

    def produce():
        calls.append(1)
        if len(calls) == 3:
            raise KeyError("disk gone")
        return len(calls)

    pf = Prefetcher(produce, depth=4)
    assert [pf.get(), pf.get()] == [1, 2]   # the items before the error
    with pytest.raises(KeyError, match="disk gone"):
        pf.get()
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_close_joins_a_blocked_worker():
    pf = Prefetcher(lambda: torch.zeros(3), depth=1)
    time.sleep(0.2)      # the worker now waits on a full queue
    t0 = time.monotonic()
    pf.close()
    assert not pf._thread.is_alive() and time.monotonic() - t0 < 2


# -- the feed paths of the train CLI ---------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("feed_cli")
    write_synthetic_dataset(str(path / "train"), 3, 30, SHAPES)
    write_synthetic_dataset(str(path / "val"), 1, 30, SHAPES, seed=9)
    return path


def _cli(data_dir, *extra):
    return cli_train.main(SMALL + [
        f"train.train_data_path=[{data_dir}/train]",
        f"train.validation_data_path=[{data_dir}/val]",
        "train.batch_size=2", "train.chunk_size=4", "train.train_iteration=3",
        "train.validation_interval=3", "train.experience_size=200",
        "train.pallas_normalize=true", *extra, "--device", "cpu",
        "--cwd", str(data_dir)])


@pytest.mark.parametrize("mode,feed,printed", [
    ("auto", "device_resident", "device-resident replay"),
    ("true", "device_resident", "device-resident replay"),
    ("stream", "stream", "streaming device-resident working set (dataset"),
    ("false", "host", "host-streamed batches")])
def test_train_cli_feed_paths(data_dir, mode, feed, printed, capsys):
    """Each ``train.device_replay`` trains with finite losses on the path
    it names and prints (the stream: 2 of 5 resident 16-row segments)."""
    budget = ["train.replay_budget_gb=1e-5"] if mode == "stream" else []
    result = _cli(data_dir, f"train.device_replay={mode}",
                  "train.stream_segment_len=16", *budget,
                  f"main.experiment_name=feed_{mode}")
    assert result["feed"] == feed
    assert printed in capsys.readouterr().out
    assert np.isfinite(list(result["metrics"].values())).all()
    assert np.isfinite(list(result["validation_metrics"].values())).all()
    assert len(result["step_seconds"]) == 3


def test_train_cli_forced_stream_raises_on_too_small_a_dataset(data_dir):
    with pytest.raises(ValueError, match="too small to stream"):
        _cli(data_dir, "train.device_replay=stream",
             "train.stream_segment_len=60")
