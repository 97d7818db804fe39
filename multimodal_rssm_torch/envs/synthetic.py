"""Dependency-free COBOTTA-schema toy environment.

A point agent on a 2-D plane is pushed around by the action's first two
components; the goal is a fixed target.  Observations follow the COBOTTA
schema the buffer/encoders expect (``image_horizon`` [64, 64, 3] uint8,
``sound`` [128, 20] float32): the image renders the agent as a coloured
square on a gradient background, the "contact microphone" spectrogram is a
deterministic pattern keyed to the agent's position, so both modalities
carry the state and a world model can actually learn the dynamics.  Used
by the online-training tests and CPU smoke runs where MuJoCo physics
(envs/peg.py) is overkill.
"""

from typing import Dict, Tuple

import numpy as np


class SyntheticEnv:
    observation_names = ("image_horizon", "sound")
    action_name = "d_pose_quat_v2"
    action_size = 3

    def __init__(self, length: int = 30, image_size: int = 64,
                 sound_shape: Tuple[int, int] = (128, 20), seed: int = 0):
        self.length = int(length)
        self.image_size = int(image_size)
        self.sound_shape = tuple(sound_shape)
        self.goal = np.array([0.5, 0.5], np.float32)
        self._rng = np.random.default_rng(seed)
        self._freqs = np.linspace(
            0.5, 4.0, self.sound_shape[0], dtype=np.float32
        )[:, None]
        self._times = np.linspace(
            0.0, 1.0, self.sound_shape[1], dtype=np.float32
        )[None, :]
        self.reset(seed)

    def reset(self, seed=None) -> Dict[str, np.ndarray]:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.pos = self._rng.uniform(-0.8, 0.8, 2).astype(np.float32)
        self.t = 0
        return self._observe()

    def step(self, action):
        a = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        self.pos = np.clip(self.pos + 0.15 * a[:2], -1.0, 1.0)
        self.t += 1
        reward = float(-np.linalg.norm(self.pos - self.goal))
        done = self.t >= self.length
        return self._observe(), reward, done

    # -- rendering ---------------------------------------------------------

    def _observe(self) -> Dict[str, np.ndarray]:
        return {"image_horizon": self._render(), "sound": self._spectrum()}

    def _render(self) -> np.ndarray:
        s = self.image_size
        img = np.zeros((s, s, 3), np.float32)
        img[:] = np.linspace(0.2, 0.45, s, dtype=np.float32)[:, None, None]
        img[..., 2] += 0.1
        # goal marker (dim) and agent square (bright), positions in [-1,1]
        for centre, colour, half in (
            (self.goal, np.array([0.2, 0.6, 0.2], np.float32), 3),
            (self.pos, np.array([0.9, 0.25, 0.2], np.float32), 4),
        ):
            cx = int((centre[0] * 0.5 + 0.5) * (s - 1))
            cy = int((centre[1] * 0.5 + 0.5) * (s - 1))
            x0, x1 = max(cx - half, 0), min(cx + half + 1, s)
            y0, y1 = max(cy - half, 0), min(cy + half + 1, s)
            img[y0:y1, x0:x1] = colour
        return (np.clip(img, 0, 1) * 255).astype(np.uint8)

    def _spectrum(self) -> np.ndarray:
        # position-keyed standing-wave pattern: frequency content shifts
        # with x, envelope with y — invertible enough to carry the state
        x, y = float(self.pos[0]), float(self.pos[1])
        phase = self._freqs * (2.0 + x) * np.pi * self._times
        envelope = np.exp(-((self._freqs - 2.0 - y) ** 2))
        spec = np.abs(np.sin(phase)) * envelope * 3.0
        return np.log1p(spec).astype(np.float32)
