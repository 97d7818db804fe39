"""PyTorch port, on the card: each hand-written kernel against its plain
version, and the paths around them that only the card can show (the
replays' copies, checkpoints, evaluation and control against the CPU).  Imports nothing of JAX, so that it runs where only the port's
dependencies are installed:

    python -m pytest --noconftest tests/test_torch_port_gpu.py -q

(``--noconftest``: the suite's conftest sets up JAX).  Without a GPU each
test skips with its reason.
"""

import pytest
import torch

from multimodal_rssm_torch.ops import cuda_kernels as ck


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU build")
    return torch.device("cuda")


@pytest.mark.gpu
def test_normalize_kernel_matches_plain_on_card(cuda):
    """The kernel equals its plain version exactly, for f32, uint8 and a
    misaligned ragged view (the scalar path), and counts each launch."""
    g = torch.Generator(cuda).manual_seed(0)
    x8 = torch.randint(0, 256, (4, 5, 64, 64, 3), generator=g, device=cuda,
                       dtype=torch.uint8)
    seed = torch.tensor(99, device=cuda)
    before = ck.normalize_image.launches
    for x in (x8.float(), x8, x8.float().reshape(-1)[1:10_003]):
        assert torch.equal(ck.normalize_image(x, 5, seed),
                           ck.normalize_image_plain(x, 5, seed))
    assert ck.normalize_image.launches == before + 3


@pytest.mark.gpu
@pytest.mark.parametrize("size", [128, 256])
def test_normalize_kernel_matches_plain_at_codec_sizes(cuda, size):
    """K1 equals its plain version bit for bit at the 128 px and 256 px
    codecs' image shapes."""
    g = torch.Generator(cuda).manual_seed(size)
    x = torch.randint(0, 256, (2, 3, size, size, 3), generator=g,
                      device=cuda, dtype=torch.uint8).float()
    seed = torch.tensor(7, device=cuda)
    before = ck.normalize_image.launches
    assert torch.equal(ck.normalize_image(x, 5, seed),
                       ck.normalize_image_plain(x, 5, seed))
    assert ck.normalize_image.launches == before + 1


@pytest.mark.gpu
def test_normalize_kernel_rejects_what_it_does_not_take(cuda):
    """A seed on another device or a float64 image raises before launch."""
    x = torch.zeros(64, device=cuda)
    before = ck.normalize_image.launches
    with pytest.raises(ValueError):
        ck.normalize_image(x, 5, torch.tensor(1))
    with pytest.raises(TypeError):
        ck.normalize_image(x.double(), 5, torch.tensor(1, device=cuda))
    assert ck.normalize_image.launches == before


# -- K2, K3a, K3b, K3c: the fused conv + InstanceNorm + GLU --------------------

FUSED_CASES = [
    # (N, H, W, Cin, kh, kw, Cout, ph, pw)
    (3, 8, 5, 8, 3, 3, 16, 1, 1),       # 40 positions per sample
    (7, 32, 5, 16, 3, 4, 32, 1, 1),     # down4's family; N = 7
    (7, 32, 4, 16, 3, 4, 32, 1, 2),     # up0's conv form: 160 positions
    (2, 16, 16, 24, 3, 3, 160, 1, 1),   # 256 positions; C/2 = 80 spans
                                        # a full and a masked column tile
    (5, 9, 7, 3, 2, 3, 10, 0, 1),       # Cin 3, C/2 = 5: scalar loads
    # Cin and Cout multiples of 64: K3b and K3c take their wgmma kernels in
    # bf16 (f32 still takes the WMMA ones)
    (3, 32, 5, 64, 3, 4, 128, 1, 1),    # down4's family, a masked column
                                        # half of the 256-wide tile
    (3, 32, 4, 256, 3, 4, 512, 1, 2),   # up0's conv form at full width
    (5, 9, 7, 64, 2, 3, 64, 0, 1),      # 280 rows: ragged last tile and
                                        # stage; taps cut on both sides
    (3, 32, 5, 64, 3, 3, 128, 1, 1),    # K3c depth 576: the last dw tile's
                                        # second 64-row atom is all masked
    # bf16 with Cin and C/2 multiples of 64: K2 takes its wgmma kernel too
    (3, 32, 5, 256, 3, 4, 512, 1, 1),   # down4 at full width
    (3, 8, 5, 64, 3, 3, 128, 1, 1),     # 40 positions, C/2 = 64: the second
                                        # pair tile of a block is masked
    (2, 16, 16, 64, 3, 3, 128, 1, 1),   # 256 positions: split across the
                                        # two warpgroups
]
# Relative to the plain version's max |value|.  f32: the same products
# summed in another order (and E[z^2] - mean^2 in the stats).  bf16: the
# outputs are rounded to bf16, where one unit in the last place is 2^-8
# of the value.
FUSED_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / (b.float().abs().max() + 1e-6))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_codec_kernels_match_plain_on_card(cuda, case, dtype):
    """Each of K2, K3a, K3b and K3c against its plain version on the same
    inputs; each call counts one launch, of the kernel that
    ``fwd_uses_wgmma`` picks for K2 (the wgmma kernel for bf16 with Cin and
    C/2 multiples of 64) and ``uses_wgmma`` for K3b and K3c (the wgmma
    kernels for bf16 with Cin and Cout multiples of 64, more than one depth
    split for K3c there); K3a's and K3c's sums are bit-equal across two
    calls (no atomics)."""
    from multimodal_rssm_torch.core.device import configure_float32
    from multimodal_rssm_torch.ops import fused_codec as fc

    configure_float32()          # the plain versions' f32 matmuls: no TF32
    n, h, wd, cin, kh, kw, cout, ph, pw = case
    g = torch.Generator(cuda).manual_seed(1)

    def draw(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * s).to(dtype)

    x = draw(n, h, wd, cin)
    w = draw(kh, kw, cin, cout, s=0.2)
    scale = torch.rand(cout, generator=g, device=cuda) + 0.5
    bias = torch.randn(cout, generator=g, device=cuda) * 0.1
    tol = FUSED_TOL[dtype]
    ck.reset_launch_counts()

    out = fc.conv_in_glu_fwd(x, w, scale, bias, (ph, pw))
    ref = fc.conv_in_glu_fwd_plain(x, w, scale, bias, (ph, pw))
    for name, a, b in zip(("y", "z", "mean", "var"), out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _rel(a, b) < tol, (name, _rel(a, b))
    _, z, mean, var = out

    dy = draw(*out[0].shape)
    dz, dscale, dbias = fc.in_glu_bwd_dz(dy, z, mean, var, scale, bias)
    ref = fc.in_glu_bwd_dz_plain(dy, z, mean, var, scale, bias)
    for name, a, b in zip(("dz", "dscale", "dbias"), (dz, dscale, dbias), ref):
        assert _rel(a, b) < tol, (name, _rel(a, b))
    again = fc.in_glu_bwd_dz(dy, z, mean, var, scale, bias)
    for a, b in zip((dz, dscale, dbias), again):
        assert torch.equal(a, b)

    dx = fc.conv_dgrad(dz, w, (ph, pw))
    assert dx.shape == x.shape
    assert _rel(dx, fc.conv_dgrad_plain(dz, w, (ph, pw))) < tol

    dw = fc.conv_wgrad(x, dz, (kh, kw), (ph, pw))
    assert dw.shape == w.shape and dw.dtype == torch.float32
    assert _rel(dw, fc.conv_wgrad_plain(x, dz, (kh, kw), (ph, pw))) < tol
    assert torch.equal(dw, fc.conv_wgrad(x, dz, (kh, kw), (ph, pw)))
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    wgmma = fc.uses_wgmma(dtype, cin, cout, kh)
    dgrad, wgrad = (("conv_dgrad_wgmma", "conv_wgrad_wgmma") if wgmma
                    else ("conv_dgrad", "conv_wgrad"))
    fwd = ("conv_in_glu_fwd_wgmma" if fc.fwd_uses_wgmma(dtype, cin, cout)
           else "conv_in_glu_fwd")
    assert {k: v for k, v in counts.items() if v} == {
        fwd: 1, "in_glu_bwd_dz": 2, dgrad: 1, wgrad: 2}
    if wgmma:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        tiles = -(-kh * kw * cin // fc.WG_TILE[0]) * -(-cout // fc.WG_TILE[1])
        assert fc.wgrad_splits(n * dz.shape[1] * dz.shape[2], tiles,
                               fc.WG_STAGE, sms)[0] > 1


@pytest.mark.gpu
def test_fused_codec_kernels_reject_what_they_do_not_take(cuda):
    """A non-contiguous input, a float64 input, an input on another device,
    too many positions per sample, or a bf16 view off 16-byte alignment
    where the wgmma kernels would run (K2, K3b and K3c: they copy 16 bytes
    at a time) raise before any launch."""
    from multimodal_rssm_torch.ops import fused_codec as fc

    x = torch.zeros(2, 8, 5, 8, device=cuda)
    w = torch.zeros(3, 3, 8, 16, device=cuda)
    s = torch.ones(16, device=cuda)
    ck.reset_launch_counts()
    with pytest.raises(ValueError):
        fc.conv_in_glu_fwd(x.transpose(1, 2), w, s, s, (1, 1))
    with pytest.raises(TypeError):
        fc.conv_in_glu_fwd(x.double(), w.double(), s, s, (1, 1))
    with pytest.raises(ValueError):
        fc.conv_in_glu_fwd(x, w, s.cpu(), s, (1, 1))
    with pytest.raises(ValueError):
        fc.conv_in_glu_fwd(torch.zeros(1, 17, 16, 8, device=cuda), w, s, s,
                           (1, 1))
    with pytest.raises(ValueError):
        fc.conv_wgrad(x, torch.zeros(2, 8, 4, 16, device=cuda), (3, 3), (1, 1))
    flat = torch.zeros(1 + 2 * 8 * 5 * 64, dtype=torch.bfloat16, device=cuda)
    xb = flat[1:].view(2, 8, 5, 64)                  # 2 bytes past alignment
    dz = torch.zeros(2, 8, 5, 64, dtype=torch.bfloat16, device=cuda)
    wb = torch.zeros(3, 3, 64, 64, dtype=torch.bfloat16, device=cuda)
    assert fc.uses_wgmma(xb.dtype, 64, 64, 3) and xb.is_contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        fc.conv_wgrad(xb, dz, (3, 3), (1, 1))
    with pytest.raises(ValueError, match="16-byte"):
        fc.conv_dgrad(flat[1:].view(2, 8, 5, 64), wb, (1, 1))
    w2 = torch.zeros(3, 3, 64, 128, dtype=torch.bfloat16, device=cuda)
    s2 = torch.ones(128, device=cuda)
    assert fc.fwd_uses_wgmma(xb.dtype, 64, 128)
    with pytest.raises(ValueError, match="16-byte"):
        fc.conv_in_glu_fwd(xb, w2, s2, s2, (1, 1))
    assert all(v == 0 for v in ck.launch_counts().values())


# -- the training run's feed and persistence ------------------------------------

SMALL = ["rssm.belief_size=64", "rssm.state_size=16", "rssm.hidden_size=64",
         "rssm.embedding_size.image=64", "rssm.embedding_size.sound=32",
         "rssm.embedding_size.fusion=64", "rssm.embedding_size.other=16",
         "train.use_amp=False"]


@pytest.fixture(scope="module")
def host_buffer(tmp_path_factory):
    """90 rows (3 episodes of 30) of the COBOTTA schema in a host replay."""
    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.data import buffer
    from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset

    path = str(tmp_path_factory.mktemp("episodes"))
    write_synthetic_dataset(path, 3, 30, {"image_horizon": [3, 64, 64],
                                          "sound": [128, 20]})
    D = buffer.build_buffer(compose(overrides=["train.experience_size=200"]))
    buffer.load_dataset(path, D, ".")
    return D


@pytest.mark.gpu
def test_device_replay_gather_on_card_matches_cpu(cuda, host_buffer):
    """DeviceReplay on the card and on the CPU hold the same rows, and
    gather_batch of one index matrix (pinned, non-blocking index copy)
    gives the same contiguous batch."""
    from multimodal_rssm_torch.data import device_buffer as db

    D = host_buffer
    on_card = db.DeviceReplay(D, cuda)
    on_cpu = db.DeviceReplay(D, torch.device("cpu"))
    idxs = D.sample_indices(8, 6)
    got = db.gather_batch(on_card.arrays, db.indices_to_device(idxs, cuda),
                          D.observation_names, on_card.row_shapes)
    want = db.gather_batch(on_cpu.arrays, torch.from_numpy(idxs),
                           D.observation_names, on_cpu.row_shapes)
    torch.cuda.synchronize()
    for g, w in zip((*got[0].values(), *got[1:]), (*want[0].values(), *want[1:])):
        assert g.is_cuda and g.is_contiguous() and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_streaming_refresh_waits_for_the_queued_step(cuda, host_buffer):
    """A gather queued behind a busy stream, then three refreshes (the
    third reuses the first staging buffer): the gather reads the rows as
    they were, the refreshed arrays equal the CPU replay's after the same
    draws, and a gather after the refreshes reads the new rows."""
    from multimodal_rssm_torch.data import device_buffer as db

    D, S, L = host_buffer, 16, 4
    kw = dict(chunk_size=L, budget_bytes=1, segment_len=S, seed=0)
    card = db.StreamingDeviceReplay(D, device=cuda, **kw)
    cpu = db.StreamingDeviceReplay(D, device=torch.device("cpu"), **kw)
    assert card.W == 2 and card.n_host_segments == 5
    idxs, cpu_idxs = card.sample_indices(8, L), cpu.sample_indices(8, L)
    names = D.observation_names
    want_before = db.gather_batch(cpu.arrays, cpu_idxs, names, cpu.row_shapes)
    first = card.resident.copy()
    torch.cuda._sleep(200_000_000)           # ~0.1 s of a busy stream
    before = db.gather_batch(card.arrays, idxs, names, card.row_shapes)
    for _ in range(3):
        assert card.refresh() == cpu.refresh()
    after = db.gather_batch(card.arrays, idxs, names, card.row_shapes)
    torch.cuda.synchronize()
    assert not (card.resident == first).all()   # rows did change
    for k in names:
        assert torch.equal(before[0][k].cpu(), want_before[0][k]), k
    for k, v in cpu.arrays.items():
        assert torch.equal(card.arrays[k].cpu(), v), k
    want_after = db.gather_batch(cpu.arrays, cpu_idxs, names, cpu.row_shapes)
    for k in names:
        assert torch.equal(after[0][k].cpu(), want_after[0][k]), k


@pytest.mark.gpu
def test_prefetcher_hands_batches_over_between_streams(cuda):
    """Items made on the worker's stream behind a slow kernel reach the
    caller's stream complete and in order."""
    from multimodal_rssm_torch.train.prefetch import Prefetcher

    made = []

    def produce():
        torch.cuda._sleep(20_000_000)
        made.append(len(made))
        return {"x": torch.full((1 << 20,), float(made[-1]), device=cuda)}

    with Prefetcher(produce, depth=2, device=cuda) as pf:
        sums = [float(pf.get()["x"].sum()) for _ in range(4)]
    assert sums == [float(i * (1 << 20)) for i in range(4)]


@pytest.mark.gpu
def test_host_batch_feed_on_card_matches_cpu(cuda, host_buffer):
    """The host feed's producer behind the prefetcher, five batches (its
    two pinned staging batches each refilled twice, a busy stream before
    each copy): every batch equals the CPU gather of the same draws."""
    import copy

    from multimodal_rssm_torch.data import buffer
    from multimodal_rssm_torch.train.prefetch import Prefetcher

    D, twin = host_buffer, copy.deepcopy(host_buffer)
    feed = buffer.HostBatchFeed(D, 8, 6, cuda)

    def produce():
        torch.cuda._sleep(20_000_000)
        return feed()

    with Prefetcher(produce, depth=2, device=cuda) as pf:
        got = [pf.get() for _ in range(5)]
    torch.cuda.synchronize()
    for state, (obs, act, rew, nt) in got:
        wobs, wact, wrew, wnt = buffer.to_device(twin.sample(8, 6),
                                                 torch.device("cpu"))
        assert state == twin.rng.bit_generator.state
        for k in wobs:
            assert obs[k].is_cuda and torch.equal(obs[k].cpu(), wobs[k]), k
        for g, w in ((act, wact), (rew, wrew), (nt, wnt)):
            assert g.is_cuda and torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """An async save of a model, Adam and a CUDA generator on the card,
    followed at once by an in-place optimizer step: the file holds the
    state at the save, and loads back bit-equal on the card."""
    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.io import checkpoint as ckpt
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.train import trainer as tr

    cfg = compose(overrides=SMALL + ["rssm.learning_rate_schedule=3"])

    def build(seed):
        model = WorldModel.from_config(cfg)
        init_parameters(model, torch.Generator().manual_seed(seed))
        model.to(cuda)
        return (model, *tr.build_optimizer(cfg, model))

    def step(model, opt, sched, g):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g, device=cuda)
        opt.step()
        sched.step()

    model, opt, sched = build(0)
    g = torch.Generator(cuda).manual_seed(1)
    step(model, opt, sched, g)
    want_model = {k: v.clone() for k, v in model.state_dict().items()}
    want_opt = {i: {k: (v.clone() if torch.is_tensor(v) else v)
                    for k, v in s.items()}
                for i, s in opt.state_dict()["state"].items()}
    saver = ckpt.AsyncCheckpointer()
    saver.save(str(tmp_path), 1, model, opt, sched,
               {"generator": g.get_state()})
    step(model, opt, sched, g)               # in place, right after the save
    path = saver.wait()
    m2, o2, s2 = build(5)
    step_no, extra = ckpt.load_checkpoint(path, m2, o2, s2)
    assert step_no == 1
    for k, v in m2.state_dict().items():
        assert v.is_cuda and torch.equal(v, want_model[k]), k
    for i, s in o2.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v.to(want_opt[i][k].device), want_opt[i][k])
    g2 = torch.Generator(cuda).set_state(extra["generator"])
    assert s2.last_epoch == 1
    step(m2, o2, s2, g2)
    for k, v in m2.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


# -- offline evaluation ---------------------------------------------------------


@pytest.fixture
def eval_models(cuda):
    """A seeded small model on the CPU and its copy on the card, both in
    eval mode, float32 with TF32 off."""
    import copy

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.core.device import configure_float32
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)

    configure_float32()
    model = WorldModel.from_config(compose(overrides=SMALL))
    init_parameters(model, torch.Generator().manual_seed(0))
    return model.eval(), copy.deepcopy(model).to(cuda).eval()


def _assert_states_close(got, want, rtol=1e-4, atol=1e-4):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_states_close(got[k], w, rtol, atol)
        else:
            torch.testing.assert_close(got[k].cpu(), w.cpu(), rtol=rtol,
                                       atol=atol, msg=k)


@pytest.mark.gpu
def test_estimate_episode_on_card_matches_cpu(cuda, host_buffer, eval_models):
    """One episode's det estimate through K1 on the card against the CPU
    model on the same prepared observations (the card's generator,
    seeded alike, draws the same normalise seed): rtol 1e-4, TF32 off."""
    from multimodal_rssm_torch.eval import state_estimation as se
    from multimodal_rssm_torch.train import trainer as tr

    cpu_model, card_model = eval_models
    D = host_buffer
    spec = tr.build_aug_spec(D)
    obs, act, _, nt = se.get_episode_data(
        D, 1, spec, se.fixed_draws(D, spec), 5,
        torch.Generator(cuda).manual_seed(3), cuda)
    got = se.estimate_episode(card_model, D, 1, spec, 5,
                              torch.Generator(cuda).manual_seed(3), det=True)
    with torch.no_grad():
        want = cpu_model.estimate_state({k: v[1:].cpu() for k, v in obs.items()},
                                        act[:-1].cpu(), nt[:-1].cpu())
    assert got["beliefs"].device.type == cuda.type
    assert got["beliefs"].shape == (29, 1, 64)
    _assert_states_close(got, want)


@pytest.mark.gpu
def test_get_states_on_card_launches_k1_once_per_episode(cuda, host_buffer,
                                                          eval_models):
    from multimodal_rssm_torch.eval import state_estimation as se

    _, card_model = eval_models
    ck.reset_launch_counts()
    states = se.get_states(card_model, host_buffer)
    assert ck.launch_counts()["normalize_image"] == host_buffer.episodes == 3
    assert list(states) == host_buffer.file_names
    assert all(s["posterior_means"].shape == (29, 1, 16)
               for s in states.values())


@pytest.mark.gpu
def test_online_filter_on_card_matches_sequence(cuda, host_buffer,
                                                eval_models):
    """The streaming filter over an episode, frame by frame on the card,
    equals the card's own det ``estimate_state`` (rtol 1e-4)."""
    from multimodal_rssm_torch.eval import state_estimation as se
    from multimodal_rssm_torch.eval.streaming import OnlineFilter
    from multimodal_rssm_torch.train import trainer as tr

    _, card_model = eval_models
    D = host_buffer
    spec = tr.build_aug_spec(D)
    obs, act, _, nt = se.get_episode_data(
        D, 2, spec, se.fixed_draws(D, spec), 5,
        torch.Generator(cuda).manual_seed(4), cuda)
    obs = {k: v[1:] for k, v in obs.items()}
    act, nt = act[:-1], nt[:-1]
    with torch.no_grad():
        seq = card_model.estimate_state(obs, act, nt)
    filt = OnlineFilter(card_model)
    steps = [filt.step(act[t], {k: v[t] for k, v in obs.items()}, nt[t])
             for t in range(act.shape[0])]
    for key in ("beliefs", "posterior_means", "prior_means"):
        torch.testing.assert_close(torch.stack([s[key] for s in steps]),
                                   seq[key], rtol=1e-4, atol=1e-4, msg=key)
    assert filt.decode()["image_horizon"]["loc"].shape == (1, 64, 64, 3)


@pytest.mark.gpu
def test_estimate_state_cli_launches_k1_for_a_run_trained_without_it(
        cuda, tmp_path):
    """A run trained on the card with the shipped default
    ``train.pallas_normalize=false`` (K1 never launched in training), then
    ``cli.estimate_state`` and ``cli.check_model`` on the card: each
    normalises every episode through K1, once per episode."""
    import os

    from multimodal_rssm_torch.cli import check_model, estimate_state, train
    from multimodal_rssm_torch.core.config import load_run_config
    from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset

    shapes = {"image_horizon": [3, 64, 64], "sound": [128, 20]}
    write_synthetic_dataset(str(tmp_path / "train"), 3, 30, shapes)
    write_synthetic_dataset(str(tmp_path / "val"), 1, 30, shapes, seed=9)
    ck.reset_launch_counts()
    run_dir = train.main(SMALL + [
        f"train.train_data_path=[{tmp_path}/train]",
        f"train.validation_data_path=[{tmp_path}/val]", "train.batch_size=2",
        "train.chunk_size=4", "train.train_iteration=2",
        "train.validation_interval=2", "train.checkpoint_interval=2",
        "train.experience_size=200", "main.experiment_name=eval_k1",
        "--cwd", str(tmp_path)])["results_dir"]
    assert load_run_config(run_dir).train.pallas_normalize is False
    assert ck.launch_counts()["normalize_image"] == 0
    saved = estimate_state.main(["--targets", os.path.dirname(run_dir),
                                 "--itr", "2", "--cwd", str(tmp_path)])
    assert len(saved) == 1
    assert ck.launch_counts()["normalize_image"] == 3
    ck.reset_launch_counts()
    check_model.main(["--run", run_dir, "--itr", "2", "--t-start", "5",
                      "--horizon", "10", "--cwd", str(tmp_path)])
    assert ck.launch_counts()["normalize_image"] == 3


# -- the RSSM's model variants -------------------------------------------------

_CAT = ["rssm.latent_dist=categorical", "rssm.categorical_params.variables=4",
        "rssm.categorical_params.classes=4"]
_POE = ["rssm.multimodal_params.fusion_method=PoE"]
_QOT = ["rssm.multimodal_params.expert_dist=q(st|ot)"]
_OVERSHOOT = ["rssm.overshooting_distance=3", "rssm.overshooting_kl_beta=1",
              "rssm.overshooting_reward_scale=1", "rssm.predict_reward=true"]
GPU_VARIANTS = {
    "unimodal": ["rssm=unimodal"],
    "poe": _POE,
    "nn": ["rssm.multimodal_params.fusion_method=NN"],
    "qot_poe": _POE + _QOT,
    "qot_mopoe": _QOT,
    "cat_mopoe": _CAT,
    "cat_poe": _CAT + _POE,
    "cat_unimodal": ["rssm=unimodal"] + _CAT,
    "overshoot_mopoe": _OVERSHOOT,
    "overshoot_cat": _OVERSHOOT + _CAT,
    "log_prob": ["rssm.worldmodel_LogProbLoss=true",
                 "rssm.predict_reward=true"],
}


def _names(enc, rec=None):
    return [f"rssm.observation_names_enc=[{','.join(enc)}]",
            f"rssm.observation_names_rec=[{','.join(rec or enc)}]"]


# the world model's remaining codecs and training options
GPU_VARIANTS.update({
    "cobotta128": _names(("image_horizon_128", "sound", "pose_quat_v2")),
    "img256_groupnorm": _names(("image_horizon_256", "sound"))
    + ["rssm.normalization=GroupNorm"],
    "img64_instancenorm_label": _names(
        ("image_horizon", "sound"), ("image_horizon", "sound", "draw_target"))
    + ["rssm.normalization=InstanceNorm",
       "env.observation_shapes.draw_target=[2]"],
    "img84_nonorm": _names(("image_horizon_84", "sound"))
    + ["rssm.normalization=None",
       "env.observation_shapes.image_horizon_84=[3,84,84]"],
    "grad_accum2": ["train.grad_accum=2"],
    "remat_conv": ["rssm.remat=conv"],
})


@pytest.mark.gpu
@pytest.mark.parametrize("variant", list(GPU_VARIANTS))
def test_variant_step_on_card_matches_cpu(cuda, variant):
    """One deterministic loss step (generator=None) of each model variant
    and codec configuration (over its ``train.grad_accum`` micro-batches),
    batch 2 x chunk 6, on the card against the CPU on the same weights,
    float32 with TF32 off: loss, every metric and the gradient norms within
    rtol 1e-4; then a step with the card's own generator (Gaussian or
    Gumbel noise drawn there) gives finite values."""
    import copy

    import numpy as np

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.core.device import configure_float32
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.ops.image import normalize_image_deterministic
    from multimodal_rssm_torch.train import trainer as tr

    configure_float32()
    cfg = compose(overrides=SMALL + ["train.chunk_size=6"]
                  + GPU_VARIANTS[variant])
    L, B = 6, 2
    rng = np.random.default_rng(0)
    shapes = cfg.env.observation_shapes
    obs = {}
    for name in sorted(set(cfg.rssm.observation_names_enc)
                       | set(cfg.rssm.observation_names_rec)):
        c, *hw = shapes[name]
        obs[name] = (normalize_image_deterministic(torch.from_numpy(
                         rng.integers(0, 256, (L, B, *hw, c), np.uint8)), 5)
                     if "image" in name else torch.from_numpy(
                         rng.normal(size=(L, B, *shapes[name])).astype(
                             np.float32)))
    raw = (obs, *(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  for s in ((L, B, 3), (L, B))), torch.ones(L, B, 1))
    cpu_model = WorldModel.from_config(cfg)
    init_parameters(cpu_model, torch.Generator().manual_seed(0))
    card_model = copy.deepcopy(cpu_model).to(cuda)

    def step(model, dev, generator=None):
        batch = ({k: v.to(dev) for k, v in raw[0].items()},
                 *(x.to(dev) for x in raw[1:]))
        model.zero_grad(set_to_none=True)
        metrics = tr.accumulated_backward(tr.make_loss_fn(model, cfg), model,
                                          batch, generator,
                                          tr.resolve_grad_accum(cfg))
        metrics.update(tr.grad_norms(model))
        return {k: float(v) for k, v in metrics.items()}

    want, got = step(cpu_model, torch.device("cpu")), step(card_model, cuda)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    noisy = step(card_model, cuda, torch.Generator(cuda).manual_seed(1))
    assert np.isfinite(list(noisy.values())).all()


# -- control ------------------------------------------------------------------------


@pytest.mark.gpu
def test_normalize_kernel_matches_plain_at_the_agent_frame_shape(cuda):
    """K1 equals its plain version at [1, 1, 64, 64, 3], the shape of each
    frame the latent agents act on: one launch."""
    x = torch.randint(0, 256, (1, 1, 64, 64, 3), device=cuda,
                      generator=torch.Generator(cuda).manual_seed(3),
                      dtype=torch.uint8).float()
    seed = torch.tensor(11, device=cuda)
    before = ck.normalize_image.launches
    assert torch.equal(ck.normalize_image(x, 5, seed),
                       ck.normalize_image_plain(x, 5, seed))
    assert ck.normalize_image.launches == before + 1


@pytest.mark.gpu
def test_full_width_behavior_step_leaves_the_world_model_bit_equal(cuda):
    """One behavior step of the default configuration at full width (bf16
    autocast, K1 on), batch 2 x chunk 6: every world-model parameter and
    running stat bit-equal, no ``.grad`` on any, its mode restored, both
    heads moved, finite metrics, K1 launched once."""
    import numpy as np

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.train import behavior as bh
    from multimodal_rssm_torch.train import trainer as tr

    cfg = bh.behavior_cfg(compose(overrides=[
        "train.chunk_size=6", "train.batch_size=2", "rssm.predict_reward=true"]))
    model = WorldModel.from_config(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.to(cuda).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bstate = bh.init_behavior_state(cfg, cuda)
    heads = [{k: v.clone() for k, v in m.state_dict().items()}
             for m in (bstate.actor, bstate.value)]
    rng = np.random.default_rng(0)
    L, B = 6, 2
    raw = ({"image_horizon": torch.from_numpy(rng.integers(
                0, 256, (L, B, 64, 64, 3), np.uint8)).to(cuda),
            "sound": torch.from_numpy(rng.normal(size=(L, B, 128, 20)).astype(
                np.float32)).to(cuda)},
           torch.from_numpy(rng.uniform(-1, 1, (L, B, 3)).astype(
               np.float32)).to(cuda),
           torch.zeros(L, B, device=cuda), torch.ones(L, B, 1, device=cuda))
    spec = tr.AugSpec(modalities=(("image_horizon", tr.ModalityAugSpec(
        (64, 64), False, False, False, True)),))
    step = bh.BehaviorStep(model, cfg, spec, cuda)
    launches = ck.normalize_image.launches
    metrics = step(bstate, raw, {"image_horizon": {}},
                   torch.Generator(cuda).manual_seed(1))
    torch.cuda.synchronize()
    assert ck.normalize_image.launches == launches + 1
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in model.parameters())
    for m, want in zip((bstate.actor, bstate.value), heads):
        assert any(not torch.equal(v, want[k])
                   for k, v in m.state_dict().items())


@pytest.mark.gpu
def test_cem_plan_on_card_matches_cpu(cuda):
    """The CEM planner at its defaults (1000 candidates, 100 elites, H 12,
    10 iterations) on a small model, float32 with TF32 off, the same noise
    on both: each iteration's elite sets equal, the plan within 1e-4."""
    import copy

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.core.device import configure_float32
    from multimodal_rssm_torch.models.world_model import (
        WorldModel, init_parameters)
    from multimodal_rssm_torch.train import planner

    configure_float32()
    cfg = planner.planner_cfg(compose(overrides=SMALL))
    model = WorldModel.from_config(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    card = copy.deepcopy(model).to(cuda)
    p = cfg.planner
    H, J, it = (int(p.planning_horizon), int(p.candidates),
                int(p.optimisation_iters))
    g = torch.Generator().manual_seed(2)
    h, s = torch.randn(2, 64, generator=g), torch.randn(2, 16, generator=g)
    noise = (torch.randn(it, H, 2, J, 3, generator=g),
             torch.randn(it, H, 2 * J, 16, generator=g))
    plans, records = [], []
    for m, dev in ((model, torch.device("cpu")), (card, cuda)):
        records.append([])
        plans.append(planner.make_cem_planner(m, cfg, full_sequence=True)(
            h.to(dev), s.to(dev), noise=noise, record=records[-1]).cpu())
    for i, (a, b) in enumerate(zip(*records)):
        for row in range(2):
            top = torch.sort(a["returns"][row], descending=True).values
            assert (set(a["elites"][row].tolist())
                    == set(b["elites"][row].cpu().tolist())), (
                i, row, float(top[99] - top[100]))
    torch.testing.assert_close(plans[1], plans[0], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_jax_msgpack_fixture_on_card_matches_the_stored_estimate(cuda):
    """The JAX package's ``.msgpack`` fixture (a unimodal pose model) read
    by the port's own reader onto the card: its det estimate equals the
    JAX package's stored one within 1e-3 |want| + 1e-4 (float32, TF32
    off)."""
    import os

    import numpy as np

    from multimodal_rssm_torch.core.config import compose
    from multimodal_rssm_torch.core.device import configure_float32
    from multimodal_rssm_torch.io.checkpoint import load_model_weights
    from multimodal_rssm_torch.models.world_model import WorldModel

    configure_float32()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_port_fixtures", "jax_unimodal_pose")
    with np.load(root + ".npz") as z:
        npz = dict(z)
    model = WorldModel.from_config(compose(overrides=[
        str(o) for o in npz["config/overrides"]]))
    load_model_weights(root + ".msgpack", model)
    model.to(cuda).eval()

    def t(key):
        return torch.from_numpy(npz[key]).to(cuda)

    with torch.no_grad():
        got = model.estimate_state({"pose_quat_v2": t("episode/pose_quat_v2")},
                                   t("episode/actions"),
                                   t("episode/nonterminals"))
    for k in ("beliefs", "posterior_means"):
        want = torch.from_numpy(npz[f"estimate/{k}"])
        diff = (got[k].cpu() - want).abs()
        assert bool((diff <= 1e-3 * want.abs() + 1e-4).all()), k


@pytest.mark.gpu
def test_histogram_pass_leaves_a_card_run_bit_equal(cuda, tmp_path):
    """4 steps of the train CLI on the card at small widths with
    ``train.histogram_interval=2`` against 4 without, under deterministic
    cuDNN: every tensor of the model bit-equal; K1 once more per
    histogram pass."""
    from multimodal_rssm_torch.cli import train as cli_train
    from multimodal_rssm_torch.data.synthetic import write_synthetic_dataset

    shapes = {"image_horizon": [3, 64, 64], "sound": [128, 20]}
    write_synthetic_dataset(str(tmp_path / "train"), 2, 30, shapes)
    write_synthetic_dataset(str(tmp_path / "val"), 1, 30, shapes, seed=9)
    small = ["rssm.belief_size=64", "rssm.state_size=16",
             "rssm.hidden_size=64", "rssm.embedding_size.image=64",
             "rssm.embedding_size.sound=32", "rssm.embedding_size.fusion=64",
             "rssm.embedding_size.other=16",
             f"train.train_data_path=[{tmp_path}/train]",
             f"train.validation_data_path=[{tmp_path}/val]",
             "train.batch_size=4", "train.chunk_size=8",
             "train.train_iteration=4", "train.validation_interval=4",
             "train.experience_size=200", "train.pallas_normalize=true"]
    runs, launches = [], []
    torch.backends.cudnn.deterministic = True
    try:
        for extra in (["train.histogram_interval=2"], []):
            ck.reset_launch_counts()
            runs.append(cli_train.main(small + extra + [
                "--device", "cuda", "--cwd", str(tmp_path)]))
            launches.append(ck.normalize_image.launches)
    finally:
        torch.backends.cudnn.deterministic = False
    assert launches == [4 + 1 + 2, 4 + 1]
    for k, v in runs[0]["model"].state_dict().items():
        assert torch.equal(v, runs[1]["model"].state_dict()[k]), k
