"""PyTorch port, the measurement tools (``multimodal_rssm_torch/cli/``:
``_profiling_common``, ``profile_step``, ``op_profile``, ``micro_bench``,
``profile_host_feed``, ``sweep_perf``, ``bench_scaling``,
``online_peg_table``) against the JAX package's ``scripts/`` they port,
imported as ``tests/test_script_helpers.py`` imports them: the tables and
helpers equal, the synthetic replay filled row for row alike, the peg
baselines' returns alike, each CLI run on the CPU for a step or two at the
``bench.py --small`` widths with the JAX script's keys and row formats.
The numbers a CPU run prints check the harness only."""

import ast
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

import bench_scaling as jbench  # noqa: E402
import online_peg_table as jpeg  # noqa: E402
import sweep_perf as jsweep  # noqa: E402
from _profiling_common import (  # noqa: E402
    fill_synthetic_buffer as jfill)

from multimodal_rssm_tpu.core.config import compose as jax_compose  # noqa: E402
from multimodal_rssm_tpu.data.buffer import build_buffer as jbuild  # noqa: E402

from multimodal_rssm_torch.cli import (  # noqa: E402
    _profiling_common as pc, bench_scaling, micro_bench, online_peg_table,
    op_profile, profile_host_feed, profile_step, sweep_perf)
from multimodal_rssm_torch.core.config import compose  # noqa: E402
from multimodal_rssm_torch.data.buffer import build_buffer  # noqa: E402

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
# the CLI runs: the --small widths, batch 2 x chunk 2 (one frame a row)
SMALL_ARGS = [a for o in pc.SMALL for a in ("--override", o)]
STEP_ARGS = ["--device", "cpu", *SMALL_ARGS]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _script_tree(name):
    with open(os.path.join(SCRIPTS, name)) as f:
        return ast.parse(f.read())


# -- the tables and helpers -----------------------------------------------------


def test_variants_are_the_jax_scripts():
    assert sweep_perf.VARIANTS == jsweep.VARIANTS
    assert list(sweep_perf.VARIANTS) == list(jsweep.VARIANTS)


@pytest.mark.parametrize("spec", ["1x1", "2x1,4X2,8x1", "1x2,2x2"])
def test_parse_meshes_is_the_jax_scripts(spec):
    assert bench_scaling.parse_meshes(spec) == jbench.parse_meshes(spec)


def test_small_is_bench_small():
    """The --small widths are the JAX script's (its own list, and its
    bench_scaling adds min_shard_width 1, as the port's does)."""
    tree = _script_tree("bench_scaling.py")
    lists = [ast.literal_eval(n.value) for n in ast.walk(tree)
             if isinstance(n, ast.AugAssign) and isinstance(n.value, ast.List)]
    assert lists == [pc.SMALL + ["train.mesh.min_shard_width=1"]]


@pytest.mark.parametrize("episodes,ep_len", [(2, 30), (3, 17)])
def test_fill_synthetic_buffer_matches_jax(episodes, ep_len):
    """Row for row: the observations, actions, rewards and nonterminals the
    port's helper writes equal the JAX helper's, the counters too."""
    over = ["train.experience_size=200"]
    D = pc.fill_synthetic_buffer(build_buffer(compose(overrides=over)),
                                 compose(overrides=over), episodes, ep_len)
    jcfg = jax_compose(overrides=over)
    J = jfill(jbuild(jcfg), jcfg, episodes=episodes, ep_len=ep_len)
    n = episodes * ep_len
    assert (D.idx, D.steps, D.episodes) == (J.idx, J.steps, J.episodes) == (
        n, n, episodes)
    assert D.observation_names == list(J.observation_names)
    for name in D.observation_names:
        np.testing.assert_array_equal(D.observations[name][:n],
                                      np.asarray(J.observations[name][:n]))
    for part in ("actions", "rewards", "nonterminals"):
        np.testing.assert_array_equal(getattr(D, part)[:n],
                                      np.asarray(getattr(J, part)[:n]))
    assert D.nonterminals[ep_len - 1, 0] == 0.0 and D.nonterminals[0, 0] == 1


def test_summarize_matches_jax():
    rng = np.random.default_rng(0)
    stats = [{"returns": list(rng.normal(-5, 1, 3)),
              "final_rewards": list(rng.uniform(-0.3, 0, 3)),
              "best_rewards": list(rng.uniform(-0.12, -0.02, 3))}
             for _ in range(2)]
    assert online_peg_table.SUCCESS_THRESHOLD == jpeg.SUCCESS_THRESHOLD
    got = online_peg_table.summarize("p", [0, 1], stats)
    assert got == jpeg.summarize("p", [0, 1], stats)
    assert 0 < got["success_rate"] < 1


@pytest.mark.parametrize("policy", ["random", "scripted"])
def test_rollout_baseline_matches_jax(policy):
    pytest.importorskip("mujoco")
    got = online_peg_table.rollout_baseline(policy, 2, 20, 0)
    want = jpeg.rollout_baseline(policy, 2, 20, 0)
    for key in ("returns", "final_rewards", "best_rewards"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)


# kernel names as an H100's torch.profiler trace of the step holds them
KERNEL_NAMES = {
    "void (anonymous namespace)::normalize_image_kernel<float>(float const*, "
    "float*, long, float, float, long const*, bool, bool, long, long, long, "
    "long, long, long)": "hand-written",
    "void wg::conv_dgrad_kernel<1>(__nv_bfloat16 const*, __nv_bfloat16 "
    "const*, __nv_bfloat16*, ConvGeom)": "hand-written",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize"
    "1x1x1_execute_segment_k_off_kernel__5x_cublas": "gemm",
    "void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_32x32"
    "_128x1_tn_align8>(cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_32x32_"
    "128x1_tn_align8::Params)": "gemm",
    "ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_stages_64x3_tn": "gemm",
    "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NNT": "gemm",
    "void splitKreduce_kernel<32, 16, int, float, __nv_bfloat16, float, "
    "__nv_bfloat16, true, false, false>(cublasSplitKParams<float>, ...)":
        "gemm",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::"
    "native::(anonymous namespace)::TensorListMetadata<4>, ...>(...)":
        "elementwise",
    "wgrad2d_shmem_tiling": "conv",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize128x128x64_warpgroupsize1x1x1_g1_execute_kernel__5x_cudnn": "conv",
    "sm80_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize64x64x64_stage4_warpsize2x2x1_g1_tensor16x8x16_kernel": "conv",
    "void wgrad2d_shmem_tiling_kernel<float, float, 3, 2>(...)": "conv",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, "
    "__nv_bfloat16, float, false, true, (cudnnKernelDataType_t)0>(...)":
        "layout",
    "void cudnn::engines_precompiled::nhwcToNchwKernel<float, __nv_bfloat16, "
    "float, true, false, (cudnnKernelDataType_t)0>(...)": "layout",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, ...)":
        "elementwise",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
    "kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() "
    "const::{lambda()#7}::operator()() const::{lambda(float)#1}, ...>":
        "elementwise",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor<float, float, "
    "float>::operator()(at::TensorIterator&)::{lambda(float, float)#1}>, "
    "unsigned int, float, 4, 4> >(...)": "reduction",
    "void at::native::batch_norm_collect_statistics_kernel<at::native::"
    "InvStd, float, float, float, int>(...)": "reduction",
    "Memcpy HtoD (Pinned -> Device)": "memcpy/memset",
    "Memset (Device)": "memcpy/memset",
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)":
        "collective",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>":
        "other",
}


@pytest.mark.parametrize("name", sorted(KERNEL_NAMES))
def test_op_category_of_real_kernel_names(name):
    hand = op_profile.hand_written_names()
    assert "normalize_image" in hand and "conv_dgrad" in hand
    assert op_profile.op_category(name, hand) == KERNEL_NAMES[name]


# -- the CLIs on the CPU ----------------------------------------------------------


def test_op_profile_on_cpu(tmp_path, capsys):
    out = op_profile.main(["--batch-size", "2", "--chunk-size", "2",
                           "--steps", "1", "--top", "5", "--trace-dir",
                           str(tmp_path), *STEP_ARGS])
    text = capsys.readouterr().out
    assert os.path.getsize(tmp_path / "op_profile.json") > 0
    assert re.search(r"total operator \(CPU\) self time: [\d.]+ ms over 1 "
                     r"steps -> [\d.]+ ms/step", text)
    assert "\ncategory attribution:\n   ms/step      %  category\n" in text
    assert len(out["top"]) == 5 and out["total_ms_per_step"] > 0
    assert set(out["categories_ms_per_step"]) <= set(op_profile.CATEGORIES)
    assert out["categories_ms_per_step"]["conv"] > 0


def test_micro_bench_on_cpu(capsys):
    out = micro_bench.main(["--frames", "49", "--device", "cpu",
                            "--modules", "image_enc_64"])
    lines = capsys.readouterr().out.splitlines()
    assert list(out) == ["image_enc_64"]
    assert set(micro_bench.CASES) == {   # the JAX script's six, by name
        "sound_enc_v2", "sound_dec_v2", "sound_enc_v1", "sound_dec_v1",
        "image_enc_64", "image_dec_64"}
    for line, name in zip(lines, out):
        assert re.fullmatch(rf"{name:16s} fwd +[\d.]+ ms   fwd\+bwd +[\d.]+ "
                            r"ms   \(bwd ~ +-?[\d.]+\)", line), line
    with pytest.raises(SystemExit):
        micro_bench.main(["--device", "cpu", "--modules", "nope"])


def _jax_keys(script, target):
    """The string keys a JAX script stores into ``target[...]`` or builds
    ``target = {...}`` from."""
    keys = []
    for n in ast.walk(_script_tree(script)):
        if (isinstance(n, ast.Subscript) and isinstance(n.value, ast.Name)
                and n.value.id == target and isinstance(n.ctx, ast.Store)):
            keys.append((n.lineno, n.col_offset, n.slice.value))
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == target
                        for t in n.targets)):
            keys += [(k.lineno, k.col_offset, k.value) for k in n.value.keys]
    return [k for *_, k in sorted(keys)]   # in the script's order


def test_profile_host_feed_on_cpu(capsys):
    out = profile_host_feed.main(["--batch-size", "2", "--chunk-size", "2",
                                  "--reps", "1", *STEP_ARGS])
    assert list(out) == _jax_keys("profile_host_feed.py", "out")
    assert json.loads(capsys.readouterr().out) == out
    assert all(np.isfinite(v) and v > 0 for v in out.values())


def test_sweep_perf_on_cpu(capsys):
    rows = sweep_perf.main(["--variants", "unroll2,nope", "--steps", "1",
                            *STEP_ARGS, "--override", "train.batch_size=2",
                            "--override", "train.chunk_size=2"])
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"unroll2    +[\d.]+ steps/s +\d+ ms/step +\d+ "
                        r"frames/s  loss [\d.]+", lines[-2]), lines[-2]
    assert lines[-1] == "nope       FAILED: KeyError: 'nope'"
    assert rows[0]["variant"] == "unroll2" and np.isfinite(rows[0]["loss"])
    assert rows[1] == {"variant": "nope", "failed": "KeyError: 'nope'"}
    with pytest.raises(SystemExit) as e:
        sweep_perf.main(["--xla", "default", "--device", "cpu"])
    assert e.value.code == 2
    assert "--xla is TPU-only" in capsys.readouterr().err


def test_bench_scaling_two_gloo_ranks(capsys):
    """--virtual-cpu 2: the one-rank shape in process, 2x1 as two gloo
    ranks (spawned), 4x1 skipped; the rows' keys and efficiency_vs_first
    are the JAX script's."""
    rows = bench_scaling.main(["--virtual-cpu", "2", "--meshes",
                               "1x1,2x1,4x1", "--small", "--json",
                               "--steps", "1", "--batch-size", "1",
                               "--chunk-size", "2"])
    captured = capsys.readouterr()
    printed = [json.loads(line) for line in captured.out.splitlines()
               if line.startswith("{")]
    assert printed == rows and len(rows) == 2
    assert "4x1: skipped (needs 4 devices, have 2)" in captured.out
    assert "numbers validate the harness, not throughput" in captured.err
    keys = _jax_keys("bench_scaling.py", "row")
    assert list(rows[0]) == keys[:-1] and list(rows[1]) == keys
    assert [r["global_batch"] for r in rows] == [1, 2]
    # (frames / devices) over the first row's frames_per_sec: the rounded
    # rows bound it (frames_per_sec to 0.1, the efficiency to 1e-3)
    f0, f1 = rows[0]["frames_per_sec"], rows[1]["frames_per_sec"]
    assert ((f1 - 0.05) / 2 / f0 - 5e-4 <= rows[1]["efficiency_vs_first"]
            <= (f1 + 0.05) / 2 / f0 + 5e-4), rows


def test_rows_are_the_jax_scripts_on_the_same_steps(monkeypatch, capsys):
    """On the same measured steps/s and losses (each script's measurement
    replaced), the port's JSON rows equal the JAX script's, its
    efficiency_vs_first included."""
    from multimodal_rssm_tpu.parallel import mesh as jmesh

    measured = {1: (2.0, 10.0), 2: (3.1234, 9.5), 4: (5.0, 9.0)}
    monkeypatch.setattr(bench_scaling, "run_shape",
                        lambda d, m, over, steps, dev: measured[d * m])
    rows = bench_scaling.main(["--virtual-cpu", "4", "--meshes",
                               "1x1,2x1,2x2", "--json", "--steps", "1"])
    capsys.readouterr()
    monkeypatch.setattr(jbench, "measure", lambda cfg, mesh, steps: measured[
        1 if mesh is None else mesh])
    monkeypatch.setattr(jmesh, "create_mesh",
                        lambda n_data, n_model, devices: n_data * n_model)
    monkeypatch.setattr(sys, "argv", ["bench_scaling.py", "--meshes",
                                      "1x1,2x1,2x2", "--json", "--steps",
                                      "1"])
    jbench.main()
    jrows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert rows == jrows and len(rows) == 3
    assert rows[2]["efficiency_vs_first"] == round(
        (5.0 * 100 * 50 / 4) / (rows[0]["frames_per_sec"] / 1), 3)


def test_online_peg_table_on_cpu(tmp_path, capsys):
    pytest.importorskip("mujoco")
    out = tmp_path / "table.md"
    rows = online_peg_table.main([
        "--device", "cpu", "--seeds", "0", "--train-episodes", "1",
        "--collect-interval", "1", "--eval-episodes", "1", "--length", "6",
        "--workdir", str(tmp_path / "work"), "--out", str(out),
        *SMALL_ARGS, "--override", "train.batch_size=2",
        "--override", "train.chunk_size=3", "--override",
        "online.seed_episodes=1", "--override", "behavior.horizon=2"])
    capsys.readouterr()
    want = jpeg.summarize("p", [0], [{"returns": [0.0], "final_rewards":
                                      [0.0], "best_rewards": [0.0]}])
    assert [r["policy"] for r in rows] == [
        "random", "scripted (demo controller)",
        "learned (online Dreamer, 1 ep/seed)"]
    assert all(list(r) == list(want) for r in rows)
    assert json.loads((tmp_path / "table.json").read_text()) == rows
    table = out.read_text().splitlines()
    assert table[4] == ("| policy | mean return | std | mean final dist (m) | "
                        "mean best dist (m) | success rate |")
    assert len(table) == 11


def test_profile_step_takes_the_jax_scripts_flags():
    """``--small --batch-size 4 --chunk-size 6 --override ...`` go into the
    config it builds as ``scripts/profile_step.py`` puts them (its seven
    --small overrides, read from the script), after K1's switch; the
    positional overrides and the port's own flags stay."""
    tree = _script_tree("profile_step.py")
    lists = [ast.literal_eval(n.value) for n in ast.walk(tree)
             if isinstance(n, ast.AugAssign) and isinstance(n.value, ast.List)]
    assert lists == [profile_step.SMALL]
    args = profile_step.parse_args([
        "--small", "--batch-size", "4", "--chunk-size", "6", "--override",
        "rssm.fusion_method=poe", "--override",
        "rssm.multimodal_params.fusion_method=PoE", "--steps", "2",
        "train.seed=3"])
    assert (args.steps, args.warmup, args.trace) == (2, 3, None)
    s = profile_step.setup(args, "cpu")
    cfg = s.cfg
    assert (cfg.train.batch_size, cfg.train.chunk_size) == (4, 6)
    assert cfg.rssm.fusion_method == "poe" and cfg.train.seed == 3
    assert cfg.rssm.belief_size == 64 and cfg.train.use_amp is False
    assert cfg.rssm.embedding_size.other == compose().rssm.embedding_size.other
    assert cfg.train.pallas_normalize is True
    assert s.model.transition_model.fusion_method == "PoE"
    assert tuple(s.raw[0]["image_horizon"].shape) == (6, 4, 64, 64, 3)
    defaults = profile_step.parse_args([])
    assert (defaults.batch_size, defaults.chunk_size, defaults.small,
            defaults.override) == (50, 50, False, [])


def test_profiler_window_keeps_quiet_edges_outside_its_timed_span(
        monkeypatch, tmp_path):
    """``core/profiling.ProfilerWindow`` (op_profile's, profile_step's and
    the train loop's window) on the CPU: ``EDGE_GAP_S`` of sleep after it
    opens and before it closes, both outside the timed span; the kernel
    (here: operator) time, the wall time and the idle share of that span;
    the launches the wrappers counted inside the window only; a warm-up
    step traced and dropped."""
    import time

    from multimodal_rssm_torch.core import profiling
    from multimodal_rssm_torch.ops import cuda_kernels as ck

    events = []

    class Clock:
        def sleep(self, seconds):
            events.append(("sleep", seconds))
            time.sleep(seconds)

        def perf_counter(self):
            events.append(("clock",))
            return time.perf_counter()

    monkeypatch.setattr(profiling, "time", Clock())
    k1 = ck._all_kernels()["normalize_image"]
    monkeypatch.setattr(k1, "launches", k1.launches + 5)
    x = torch.randn(64, 64)
    with profiling.ProfilerWindow(torch.device("cpu")) as window:
        events.append(("work",))
        for _ in range(3):
            x = torch.tanh(x @ x.t())
        k1.launches += 2
    assert [e[0] for e in events] == ["sleep", "clock", "work", "clock",
                                      "sleep"]
    assert events[0][1] == events[-1][1] == profiling.EDGE_GAP_S
    assert window.launches == {"normalize_image": 2}
    s = window.summary()
    assert s["launches"] == window.launches
    assert 0 < s["kernel_ms"] and 0 < s["wall_ms"]
    assert s["device_idle_share"] == pytest.approx(
        1 - s["kernel_ms"] / s["wall_ms"])
    names = {name for name, _, _ in window.kernels()}
    assert {"aten::mm", "aten::tanh"} <= names

    events.clear()
    warm = profiling.ProfilerWindow(torch.device("cpu")).open(
        warmup=lambda: torch.sin(x))
    torch.cos(x)
    warm.close()
    names = {name for name, _, _ in warm.kernels()}
    assert "aten::cos" in names and "aten::sin" not in names
    assert not any(n.startswith("ProfilerStep") for n in names)
    assert [e[0] for e in events] == ["sleep", "clock", "clock", "sleep"]

    assert s["hand_written_in_trace"] == {}   # no kernel on the CPU


def test_profiler_window_reads_only_the_timed_spans_kernels():
    """``ProfilerWindow`` on a CUDA device, its profiler's records faked
    (no card here): the window's own empty warm-up kernels (ATen's
    ``spin_kernel``) and the annotations mirrored onto the device are left
    out of the kernel time, the counts and the idle share; K1's records
    are counted; a window that traces the host as well names its idle
    share ``device_idle_share_host_traced``, one of the card alone
    ``device_idle_share``."""
    from types import SimpleNamespace

    from multimodal_rssm_torch.core import profiling

    cuda = torch.autograd.DeviceType.CUDA

    def record(name, us, device=cuda, annotation=False):
        return SimpleNamespace(
            name=lambda: name, duration_ns=lambda: int(us * 1e3),
            device_type=lambda: device,
            is_user_annotation=lambda: annotation)

    records = (
        [record("at::cuda::(anonymous namespace)::spin_kernel(long)", 2.0)]
        * profiling.WARMUP_LAUNCHES
        + [record("ProfilerStep#1", 900.0, annotation=True),
           record("normalize_image_kernel", 30.0),
           record("normalize_image_kernel", 30.0),
           record("sm90_xmma_gemm_bf16", 240.0),
           record("aten::mm", 500.0, device=torch.autograd.DeviceType.CPU)])
    kineto = SimpleNamespace(events=lambda: records)
    for cpu, key in ((True, "device_idle_share_host_traced"),
                     (False, "device_idle_share")):
        window = profiling.ProfilerWindow(torch.device("cuda"), cpu=cpu)
        window.prof = SimpleNamespace(
            profiler=SimpleNamespace(kineto_results=kineto))
        window.wall_ms, window.launches = 1.0, {"normalize_image": 2}
        assert sorted(window.kernels()) == [
            ("normalize_image_kernel", 60.0, 2),
            ("sm90_xmma_gemm_bf16", 240.0, 1)]
        s = window.summary()
        assert s["kernel_ms"] == pytest.approx(0.3)
        assert s[key] == pytest.approx(0.7) and len(s) == 5
        assert s["hand_written_in_trace"] == {"normalize_image": 2}


def test_step_setup_and_profile_step_device(monkeypatch):
    """``build_step_setup`` on the CPU: the synthetic batch's layout, K1's
    flag resolved to the plain path there, one step's finite loss;
    profile_step (CUDA events) raises without a GPU."""
    s = pc.build_step_setup(2, 3, pc.SMALL, "cpu")
    obs, act, rew, nt = s.raw
    assert obs["image_horizon"].dtype == torch.uint8
    assert tuple(obs["image_horizon"].shape) == (3, 2, 64, 64, 3)
    assert tuple(act.shape) == (3, 2, 3) and bool((nt == 1).all())
    assert s.cfg.train.pallas_normalize == "auto"
    assert np.isfinite(float(s.train_step(s.raw, s.draws, s.generator)["loss"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_step.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        op_profile.main(["--steps", "1"])
