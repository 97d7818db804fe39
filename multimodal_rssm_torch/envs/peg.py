"""Steppable MuJoCo peg-insertion environment.

The reference ships MuJoCo 2.0 only inside a Docker image
(docker/with_simulation_env/ — no env code exists in its repo).  This
module is the interactive form of this repo's sim data collector: the same
scene, rendering, contact-force spectrogram and pose conventions as
the JAX package's collect_sim_data CLI (which builds on this class for
its scripted collection), exposed as reset/step so a learned actor can drive
it (multimodal_rssm_torch/train/online.py).

Observation schema matches the COBOTTA dataset exactly:
``image_horizon`` [S, S, 3] uint8, ``sound`` [128, 20] float32 (log-STFT of
the summed contact force — the contact-microphone analogue),
``pose_quat_v2`` [3] float32; action = commanded position delta in
[-1, 1]^3 (stored convention: delta / 0.05 m, matching the collector).
"""

import os
from typing import Dict

import numpy as np

SCENE_XML = """
<mujoco model="peg_insertion">
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <light pos="0 0 3" dir="0 0 -1"/>
    <geom name="floor" type="plane" size="1 1 .1" rgba=".35 .4 .45 1"/>
    <!-- block with a square opening, built from 4 boxes -->
    <geom name="b0" type="box" pos="0 .09 .05" size=".12 .03 .05" rgba=".7 .55 .3 1"/>
    <geom name="b1" type="box" pos="0 -.09 .05" size=".12 .03 .05" rgba=".7 .55 .3 1"/>
    <geom name="b2" type="box" pos=".09 0 .05" size=".03 .06 .05" rgba=".7 .55 .3 1"/>
    <geom name="b3" type="box" pos="-.09 0 .05" size=".03 .06 .05" rgba=".7 .55 .3 1"/>
    <body name="peg" pos="0 0 .3">
      <joint name="px" type="slide" axis="1 0 0" range="-.4 .4" damping="8"/>
      <joint name="py" type="slide" axis="0 1 0" range="-.4 .4" damping="8"/>
      <joint name="pz" type="slide" axis="0 0 1" range="-.28 .2" damping="8"/>
      <geom name="peg_shaft" type="capsule" fromto="0 0 0 0 0 .12" size=".035"
            rgba=".85 .2 .2 1" density="2000"/>
      <site name="tip" pos="0 0 0" size=".005"/>
    </body>
  </worldbody>
  <actuator>
    <position joint="px" kp="60"/>
    <position joint="py" kp="60"/>
    <position joint="pz" kp="60"/>
  </actuator>
</mujoco>
"""

HOLE = np.array([0.0, 0.0, 0.05], np.float64)
POS_SCALE = np.array([0.4, 0.4, 0.3], np.float64)  # joint ranges -> [-1, 1]
ACTION_SCALE = 0.05  # metres of commanded delta per unit action


def software_render(model, data, size=64):
    """Painter's-algorithm rasterizer over the scene geoms (orthographic,
    looking down the -y axis tilted 35deg) — the GL-free fallback.  Crude
    but dynamics-consistent: the peg and block move exactly as simulated.
    """
    img = np.zeros((size, size, 3), np.float32)
    # background: vertical gradient (floor/sky analogue)
    img[:] = np.linspace(0.25, 0.1, size, dtype=np.float32)[:, None, None]
    img[..., 2] += 0.08

    c, s = np.cos(np.deg2rad(35)), np.sin(np.deg2rad(35))
    cam_fwd = np.array([0.0, c, -s])  # view direction

    order = []
    for g in range(model.ngeom):
        if model.geom(g).name == "floor":
            continue
        pos = data.geom_xpos[g]
        depth = pos @ cam_fwd
        order.append((depth, g))
    order.sort()  # far first

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    world_w = 0.8  # metres spanned by the image
    for _, g in order:
        geom = model.geom(g)
        pos = data.geom_xpos[g]
        # orthographic: u from x, v from (tilted) y/z
        u = (pos[0] / world_w + 0.5) * size
        v = (0.5 - (pos[2] * c + pos[1] * s) / world_w) * size
        sz = geom.size
        # box (mjGEOM_BOX=6): use the largest half-extent; sphere/capsule:
        # sz[0] is the radius
        if sz.size == 0:
            r = 0.03
        elif int(np.ravel(geom.type)[0]) == 6:
            r = float(np.max(sz))
        else:
            r = float(sz[0])
        r_px = max(2.0, r / world_w * size * 1.6)
        rgba = np.asarray(geom.rgba[:3], np.float32)
        mask = ((xx - u) ** 2 + (yy - v) ** 2) <= r_px ** 2
        shade = 0.75 + 0.25 * np.clip((v - yy[:, 0:1]).mean() / size, -1, 1)
        img[mask] = rgba * shade
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def try_gl_renderer(model, size=64):
    """Only attempt the GL renderer when MUJOCO_GL names a headless
    backend: probing blindly in GL-less containers aborts the process
    inside the GLFW fallback (native crash, not a Python exception)."""
    if os.environ.get("MUJOCO_GL") not in ("egl", "osmesa"):
        return None
    try:
        import mujoco

        return mujoco.Renderer(model, size, size)
    except Exception:
        return None


def contact_force_sample(model, data):
    import mujoco

    total = 0.0
    buf = np.zeros(6)
    for i in range(data.ncon):
        mujoco.mj_contactForce(model, data, i, buf)
        total += float(np.linalg.norm(buf[:3]))
    return total


def spectrogram(signal, n_freq=128, n_time=20, win=256, hop=64):
    """|STFT| of the trailing force signal -> [n_freq, n_time]."""
    need = win + hop * (n_time - 1)
    sig = np.zeros(need, np.float32)
    tail = np.asarray(signal[-need:], np.float32)
    if len(tail):  # reset-time observation: no force samples yet
        sig[-len(tail):] = tail
    window = np.hanning(win).astype(np.float32)
    cols = []
    for t in range(n_time):
        seg = sig[t * hop: t * hop + win] * window
        mag = np.abs(np.fft.rfft(seg))[:n_freq]
        cols.append(mag)
    spec = np.stack(cols, axis=1)
    return np.log1p(spec).astype(np.float32)


class PegInsertionEnv:
    observation_names = ("image_horizon", "sound", "pose_quat_v2")
    action_name = "d_pose_quat_v2"
    action_size = 3

    def __init__(self, length: int = 100, substeps: int = 10,
                 render_size: int = 64, seed: int = 0):
        import mujoco

        self._mujoco = mujoco
        self.length = int(length)
        self.substeps = int(substeps)
        self.render_size = int(render_size)
        self.model = mujoco.MjModel.from_xml_string(SCENE_XML)
        self.data = mujoco.MjData(self.model)
        self.renderer = try_gl_renderer(self.model, render_size)
        self.reset(seed)

    def reset(self, seed=None) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(seed)
        self._mujoco.mj_resetData(self.model, self.data)
        # random start above the block
        self.target = np.array(
            [rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3), 0.15]
        )
        self.data.qpos[:] = self.target
        self._mujoco.mj_forward(self.model, self.data)
        self.force_signal = []
        self.t = 0
        return self._observe()

    def step(self, action):
        delta = np.asarray(action, np.float64) * ACTION_SCALE
        self.target = np.clip(
            self.target + delta, [-0.4, -0.4, -0.28], [0.4, 0.4, 0.2]
        )
        self.data.ctrl[:] = self.target
        for _ in range(self.substeps):
            self._mujoco.mj_step(self.model, self.data)
            self.force_signal.append(
                contact_force_sample(self.model, self.data)
            )
        self.t += 1
        reward = float(
            -np.linalg.norm(self.data.site("tip").xpos - HOLE)
        )
        done = self.t >= self.length
        return self._observe(), reward, done

    def scripted_action(self, rng) -> np.ndarray:
        """The demonstration policy (move over the hole, descend and
        grind) in env-action units; used by the sim data collector."""
        tip = self.data.site("tip").xpos.copy()
        to_hole = HOLE + np.array([0, 0, 0.12]) - tip
        if np.linalg.norm(to_hole[:2]) > 0.02:
            delta = np.clip(to_hole * 0.25, -0.04, 0.04)
        else:
            delta = np.array([0.0, 0.0, -0.03])
        delta = delta + rng.normal(0, 0.006, 3)
        return (delta / ACTION_SCALE).astype(np.float32)

    def _observe(self) -> Dict[str, np.ndarray]:
        if self.renderer is not None:
            try:
                self.renderer.update_scene(self.data)
                frame = self.renderer.render()
            except Exception:
                self.renderer = None
                frame = software_render(self.model, self.data,
                                        self.render_size)
        else:
            frame = software_render(self.model, self.data, self.render_size)
        pose = (
            np.asarray(self.data.qpos[:3], np.float64) / POS_SCALE
        ).astype(np.float32)
        return {
            "image_horizon": frame,
            "sound": spectrogram(self.force_signal),
            "pose_quat_v2": pose,
        }
