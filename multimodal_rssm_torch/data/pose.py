"""Robot pose normalisation / denormalisation (COBOTTA channels).

A copy of the JAX package's ``data/pose.py``, itself a port of the
reference's dataset/COBOTTA/pose_processing.py: the fixed affine scalings that
turn raw robot poses into the normalised observation/action channels named
in the env config (``pose_quat_v2``, ``d_pose_quat_v2``, ...), plus the
name-dispatch ``postprocess_pose`` and the episode-level ``preprocess_pose``
that derives every channel.  Pure NumPy (host-side dataset preparation).

Deviation (documented): the reference's ``shift_prev_time`` is an exact
copy of ``shift_next_time`` (pose_processing.py:15-21 — an apparent bug);
here it genuinely shifts backwards.  Set ``ref_compat=True`` on
``preprocess_pose`` to reproduce the reference's buggy channels bit-for-bit
for parity runs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def shift_next_time(pose: np.ndarray) -> np.ndarray:
    """x_next[t] = x[t+1], final row zero (ref :7-13)."""
    out = np.zeros_like(pose)
    out[:-1] = pose[1:]
    return out


def shift_prev_time(pose: np.ndarray) -> np.ndarray:
    """x_prev[t] = x[t-1], first row zero (the reference's version is a
    duplicate of shift_next_time — see module docstring)."""
    out = np.zeros_like(pose)
    out[1:] = pose[:-1]
    return out


# -- v1 scalings (ref :25-102) -------------------------------------------


def normalize_pose_rpy_v1(pose):
    out = np.array(pose, copy=True)
    out[:, 0] -= 0.3
    out[:, :3] *= 100
    out[:, 3:] = out[:, 3:] / 180 / np.pi
    return out


def reverse_pose_rpy_v1(pose):
    out = np.array(pose, copy=True)
    out[:, :3] /= 100
    out[:, 0] += 0.3
    out[:, 3:] = out[:, 3:] * 180 * np.pi
    return out


def normalize_d_pose_rpy_v1(pose_norm):
    out = np.zeros_like(pose_norm)
    out[:-1] = pose_norm[1:] - pose_norm[:-1]
    out[:, :3] *= 10
    out[:, 3:] *= 1000
    return out


def reverse_d_pose_rpy_v1(d_pose_norm):
    out = np.array(d_pose_norm, copy=True)
    out[:, :3] = out[:, :3] / 10 / 100
    out[:, 3:] = out[:, 3:] / 1000 * 180 * np.pi
    return out


def normalize_pose_quat_v1(pose):
    out = np.array(pose, copy=True)
    out[:, 0] -= 0.3
    out[:, :3] *= 100
    return out


def reverse_pose_quat_v1(pose_norm):
    out = np.array(pose_norm, copy=True)
    out[:, :3] /= 100
    out[:, 0] += 0.3
    return out


def normalize_d_pose_quat_v1(pose_norm):
    out = np.zeros_like(pose_norm)
    out[:-1] = pose_norm[1:] - pose_norm[:-1]
    out[:, :3] *= 10
    out[:, 3:] *= 1000
    return out


def reverse_d_pose_quat_v1(d_pose_norm):
    out = np.array(d_pose_norm, copy=True)
    out[:, :3] = out[:, :3] / 10 / 100
    out[:, 3:] /= 1000
    return out


# -- v2 scalings (ref :105-137) ------------------------------------------


def normalize_pose_quat_v2(pose):
    out = np.array(pose, copy=True)
    out[:, :3] *= 25
    return out


def reverse_pose_quat_v2(pose_norm):
    out = np.array(pose_norm, copy=True)
    out[:, :3] /= 25
    return out


def normalize_d_pose_quat_v2(pose):
    out = np.zeros_like(pose)
    out[:-1] = pose[1:] - pose[:-1]
    out[:, :3] *= 2000
    out[:, 3:] *= 800
    return out


def reverse_d_pose_quat_v2(d_pose_norm):
    out = np.array(d_pose_norm, copy=True)
    out[:, :3] /= 2000
    out[:, 3:] /= 800
    return out


def postprocess_pose(name: str, pose: np.ndarray) -> np.ndarray:
    """Name-dispatch denormalisation (ref :140-154).  Substring-match order
    matters (``d_pose_*`` before ``pose_*``)."""
    if "d_pose_rpy_norm" in name:
        return reverse_d_pose_rpy_v1(pose)
    if "pose_rpy_norm" in name:
        return reverse_pose_rpy_v1(pose)
    if "d_pose_quat_norm" in name:
        return reverse_d_pose_quat_v1(pose)
    if "pose_quat_norm" in name:
        return reverse_pose_quat_v1(pose)
    if "d_pose_quat_v2" in name:
        return reverse_d_pose_quat_v2(pose)
    if "pose_quat_v2" in name:
        return reverse_pose_quat_v2(pose)
    return pose


def preprocess_pose(data: Dict[str, np.ndarray], ref_compat: bool = False):
    """Derive every normalised pose channel for an episode (ref :157-183)."""
    prev = shift_next_time if ref_compat else shift_prev_time
    if "pose_rpy" in data:
        data["pose_rpy_next"] = shift_next_time(data["pose_rpy"])
        data["pose_rpy_norm"] = normalize_pose_rpy_v1(data["pose_rpy"])
        data["pose_rpy_norm_next"] = shift_next_time(data["pose_rpy_norm"])
        data["d_pose_rpy_norm"] = normalize_d_pose_rpy_v1(data["pose_rpy_norm"])
        data["d_pose_rpy_norm_prev"] = prev(data["d_pose_rpy_norm"])
    if "pose_quat" in data:
        data["pose_quat_next"] = shift_next_time(data["pose_quat"])
        data["pose_quat_norm"] = normalize_pose_quat_v1(data["pose_quat"])
        data["pose_quat_norm_next"] = shift_next_time(data["pose_quat_norm"])
        data["d_pose_quat_norm"] = normalize_d_pose_quat_v1(data["pose_quat_norm"])
        data["d_pose_quat_norm_prev"] = prev(data["d_pose_quat_norm"])
        data["pose_quat_v2"] = normalize_pose_quat_v2(data["pose_quat"])
        data["pose_quat_v2_next"] = shift_next_time(data["pose_quat_v2"])
        data["d_pose_quat_v2"] = normalize_d_pose_quat_v2(data["pose_quat"])
        data["d_pose_quat_v2_prev"] = prev(data["d_pose_quat_v2"])
    if "servo_value" in data:
        data["servo_value_next"] = shift_next_time(data["servo_value"])
    return data


def preprocess_pose_seq(data: Dict[str, np.ndarray], pose_prev: np.ndarray):
    """Online variant against a previous pose (ref :185-193)."""
    if "pose_quat" in data:
        action_size = pose_prev.shape[1]
        data["pose_quat_v2"] = normalize_pose_quat_v2(
            data["pose_quat"][:, :action_size]
        )
        d = data["pose_quat"][:, :action_size] - pose_prev
        d[:, :3] *= 2000
        d[:, 3:] *= 800
        data["d_pose_quat_v2_prev"] = d
    return data
