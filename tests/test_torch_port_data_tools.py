"""PyTorch port, the dataset tools: ``data/pose.py``,
``data/dataset_builder.py`` (its PIL-free resize), and the
``make_synthetic_dataset`` / ``collect_sim_data`` CLIs, held against the
JAX package's modules and CLIs on the same inputs.  Everything here is
host-side NumPy, so every comparison is exact: the pose scalings
elementwise, the resize bit-equal to PIL's ``Image.BILINEAR`` on uint8
frames (RGB and single-channel, downscales from frames larger than 256 px
to 256 / 128 / 64 and upscales), the built episodes and the written files
array for array.
"""

import os
import sys

import numpy as np
import pytest
from PIL import Image

from multimodal_rssm_tpu.cli import collect_sim_data as jax_collect
from multimodal_rssm_tpu.cli import make_synthetic_dataset as jax_make
from multimodal_rssm_tpu.data import dataset_builder as jax_builder
from multimodal_rssm_tpu.data import pose as jax_pose

from multimodal_rssm_torch.cli import collect_sim_data, make_synthetic_dataset
from multimodal_rssm_torch.data import dataset_builder, pose
from multimodal_rssm_torch.envs import make_env

NORMALISERS = [
    "normalize_pose_rpy_v1", "reverse_pose_rpy_v1", "normalize_d_pose_rpy_v1",
    "reverse_d_pose_rpy_v1", "normalize_pose_quat_v1", "reverse_pose_quat_v1",
    "normalize_d_pose_quat_v1", "reverse_d_pose_quat_v1",
    "normalize_pose_quat_v2", "reverse_pose_quat_v2",
    "normalize_d_pose_quat_v2", "reverse_d_pose_quat_v2", "shift_next_time",
    "shift_prev_time"]


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _raw(rng, T=6, hw=(300, 400), c=3):
    """A raw recording: frames larger than 256 px (smooth + noise), sound,
    a 7-d pose, servo values, a reward and a mid-episode done."""
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    frames = np.stack([
        np.clip(((np.sin(xx / (5.0 + t)) + np.cos(yy / 9.0)) * 60 + 128)[
            ..., None] + rng.normal(0, 20, (*hw, c)), 0, 255)
        for t in range(T)]).astype(np.uint8)
    done = np.zeros(T)
    done[T // 2] = 1
    return {"image": frames, "sound": rng.normal(size=(T, 128, 20)),
            "pose_quat": rng.normal(size=(T, 7)),
            "pose_rpy": rng.normal(size=(T, 6)),
            "servo_value": rng.normal(size=(T, 6)),
            "reward": rng.normal(size=T), "done": done}


# -- pose ----------------------------------------------------------------------


@pytest.mark.parametrize("name", NORMALISERS)
def test_pose_scalings_match_jax(name):
    x = np.random.default_rng(0).normal(size=(9, 7)).astype(np.float32)
    np.testing.assert_array_equal(getattr(pose, name)(x),
                                  getattr(jax_pose, name)(x))


@pytest.mark.parametrize("name", [
    "d_pose_rpy_norm", "pose_rpy_norm", "d_pose_quat_norm_prev",
    "pose_quat_norm", "d_pose_quat_v2", "pose_quat_v2_next", "sound"])
def test_postprocess_pose_matches_jax(name):
    x = np.random.default_rng(1).normal(size=(5, 7)).astype(np.float32)
    np.testing.assert_array_equal(pose.postprocess_pose(name, x),
                                  jax_pose.postprocess_pose(name, x))


@pytest.mark.parametrize("ref_compat", [False, True])
def test_preprocess_pose_matches_jax(ref_compat):
    """Every derived channel, with the reference's shift_prev_time bug
    (``ref_compat=True``) and with the real backward shift; both ways
    round trip through ``postprocess_pose``."""
    rng = np.random.default_rng(2)
    data = {"pose_rpy": rng.normal(size=(8, 6)).astype(np.float32),
            "pose_quat": rng.normal(size=(8, 7)).astype(np.float32),
            "servo_value": rng.normal(size=(8, 6)).astype(np.float32)}
    got = pose.preprocess_pose({k: v.copy() for k, v in data.items()},
                               ref_compat=ref_compat)
    _assert_same(got, jax_pose.preprocess_pose(
        {k: v.copy() for k, v in data.items()}, ref_compat=ref_compat))
    prev = got["d_pose_quat_v2_prev"]
    want_prev = (got["d_pose_quat_v2"][1:] if ref_compat
                 else got["d_pose_quat_v2"][:-1])
    np.testing.assert_array_equal(prev[:-1] if ref_compat else prev[1:],
                                  want_prev)
    np.testing.assert_allclose(
        pose.postprocess_pose("pose_quat_v2", got["pose_quat_v2"]),
        data["pose_quat"], rtol=1e-6)
    seq = {"pose_quat": data["pose_quat"][:2].copy()}
    _assert_same(pose.preprocess_pose_seq(dict(seq), data["pose_quat"][:2, :3]),
                 jax_pose.preprocess_pose_seq(dict(seq),
                                              data["pose_quat"][:2, :3]))


# -- the resize -------------------------------------------------------------------


def _pil_resize(images, size):
    """The JAX package's resize (PIL, frame by frame)."""
    out = []
    for frame in images:
        img = Image.fromarray(frame if frame.shape[-1] != 1 else frame[..., 0])
        r = np.asarray(img.resize((size, size), Image.BILINEAR))
        out.append(r[..., None] if r.ndim == 2 else r)
    return np.stack(out)


@pytest.mark.parametrize("hw,c", [((480, 640), 3), ((300, 400), 3),
                                  ((1024, 1024), 3), ((257, 1000), 1),
                                  ((256, 333), 3), ((333, 256), 3),
                                  ((37, 50), 3), ((100, 90), 1)])
def test_resize_is_bit_equal_to_pil(hw, c):
    """Random, smooth and two-level frames (so every rounding of both
    passes is exercised; 10 frames, more than one pass holds) to 256 / 128
    / 64 px: no differing pixel."""
    rng = np.random.default_rng(hw[0])
    frames = rng.integers(0, 256, (10, *hw, c), dtype=np.uint8)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    frames[1] = np.clip((np.sin(xx / 7.0) + np.cos(yy / 11.0))[..., None]
                        * 60 + 128, 0, 255).astype(np.uint8)
    frames[2] = 255 * (frames[2] > 128)
    for size in (256, 128, 64):
        got = dataset_builder.resize_images(frames, size)
        assert got.dtype == np.uint8 and got.shape == (10, size, size, c)
        np.testing.assert_array_equal(got, _pil_resize(frames, size))


# -- the builder ------------------------------------------------------------------


@pytest.mark.parametrize("binary", [False, True])
def test_build_episode_matches_jax(binary):
    """Key for key: image_horizon and its _64 alias, _128 / _256, the
    ``*_bin`` channels, sound, every pose channel, reward, done with
    done[-1] = 1 (the recording's mid-episode done kept)."""
    raw = _raw(np.random.default_rng(3))
    got = dataset_builder.build_episode(raw, binary=binary)
    _assert_same(got, jax_builder.build_episode(raw, binary=binary))
    assert got["done"][-1] == 1 and got["done"][3] == 1
    assert ("image_horizon_128_bin" in got) == binary
    np.testing.assert_array_equal(got["image_horizon"],
                                  got["image_horizon_64"])


def test_adaptive_threshold_matches_jax():
    frames = np.random.default_rng(4).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    for x in (frames, frames[..., :1]):
        np.testing.assert_array_equal(dataset_builder.adaptive_threshold(x),
                                      jax_builder.adaptive_threshold(x))


@pytest.mark.parametrize("n", [1, 5])
def test_build_dataset_matches_jax(n, tmp_path):
    """The same files under train/ and validation/ (the split: one
    validation episode of 5, none of 1), array for array."""
    rng = np.random.default_rng(5)
    raws = [_raw(rng, T=4, hw=(260, 270)) for _ in range(n)]
    kw = {"image_sizes": (64, 128), "camera_prefix": "image_vertical"}
    dataset_builder.build_dataset(raws, str(tmp_path / "port"), **kw)
    jax_builder.build_dataset(raws, str(tmp_path / "jax"), **kw)
    for split in ("train", "validation"):
        names = sorted(os.listdir(tmp_path / "jax" / split))
        assert sorted(os.listdir(tmp_path / "port" / split)) == names
        assert len(names) == {"train": n - (n > 1), "validation": int(
            n > 1)}[split]
        for name in names:
            _assert_same(
                np.load(tmp_path / "port" / split / name,
                        allow_pickle=True).item(),
                np.load(tmp_path / "jax" / split / name,
                        allow_pickle=True).item())


# -- the CLIs ---------------------------------------------------------------------


def _same_tree(a, b):
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names and names
    for name in names:
        if os.path.isdir(os.path.join(b, name)):
            _same_tree(os.path.join(a, name), os.path.join(b, name))
        else:
            _assert_same(np.load(os.path.join(a, name),
                                 allow_pickle=True).item(),
                         np.load(os.path.join(b, name),
                                 allow_pickle=True).item())


def test_make_synthetic_dataset_matches_the_jax_cli(tmp_path, monkeypatch):
    args = ["--episodes", "5", "--length", "12", "--seed", "3",
            "--modalities", "image_horizon,sound,pose_quat_v2,draw_target"]
    make_synthetic_dataset.main(["--out", str(tmp_path / "port"), *args])
    monkeypatch.setattr(sys, "argv", ["make_synthetic_dataset", "--out",
                                      str(tmp_path / "jax"), *args])
    jax_make.main()
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_collect_sim_data_matches_the_jax_cli(tmp_path, monkeypatch):
    """``--env synthetic``, episodes that run their whole length: the JAX
    CLI's files, array for array."""
    args = ["--env", "synthetic", "--episodes", "4", "--length", "9",
            "--seed", "2"]
    collect_sim_data.main(["--out", str(tmp_path / "port"), *args])
    monkeypatch.setattr(sys, "argv", ["collect_sim_data", "--out",
                                      str(tmp_path / "jax"), *args])
    jax_collect.main()
    _same_tree(str(tmp_path / "port"), str(tmp_path / "jax"))
    ep = np.load(tmp_path / "port" / "train" / "episode_0000.npy",
                 allow_pickle=True).item()
    assert ep["image_horizon"].shape == (9, 64, 64, 3)
    assert ep["done"].tolist() == [0.0] * 8 + [1.0]


def test_collector_stops_at_done():
    """An env whose episode ends before ``length``: the port stops at its
    ``done`` (rows 0..4, done at the last); the JAX collector steps the
    finished env on to ``length`` (a deliberate difference), its first
    rows the port's."""
    got = collect_sim_data.collect_episode(10, 7, env=make_env(
        "synthetic", length=5))
    from multimodal_rssm_tpu.envs import make_env as jax_make_env

    want = jax_collect.collect_episode(10, 7, env=jax_make_env(
        "synthetic", length=5))
    assert got["done"].tolist() == [0.0] * 4 + [1.0]
    assert len(want["done"]) == 10 and want["done"][4:].all()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k][:5], err_msg=k)


def test_collector_builds_one_env_per_split_and_closes_it(tmp_path,
                                                          monkeypatch):
    made, closed = [], []

    class Env:
        observation_names = ("image_horizon",)
        action_size = 3

        def __init__(self, length, seed):
            self.length, self.t = length, 0
            self.env = self
            made.append(seed)

        def reset(self, seed=None):
            self.t = 0
            return {"image_horizon": np.full((64, 64, 3), seed, np.uint8)}

        def step(self, action):
            self.t += 1
            return ({"image_horizon": np.zeros((64, 64, 3), np.uint8)}, 0.0,
                    self.t >= self.length)

        def close(self):
            closed.append(True)

    monkeypatch.setattr("multimodal_rssm_torch.envs.make_env",
                        lambda name, length, seed: Env(length, seed))
    collect_sim_data.main(["--out", str(tmp_path), "--env", "gym:Fake-v0",
                           "--episodes", "4", "--length", "3"])
    assert made == [0, 10_000] and len(closed) == 2
    ep = np.load(tmp_path / "train" / "episode_0002.npy",
                 allow_pickle=True).item()
    assert ep["image_horizon"][0, 0, 0, 0] == 2    # reset with seed0 + i
