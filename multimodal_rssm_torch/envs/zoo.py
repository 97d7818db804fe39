"""External-environment adapters: gym/gymnasium, dm_control, robosuite.

Reference parity: the reference's simulation Docker image installs
mujoco-py, robosuite, gym and dm_control
(the reference's docker/with_simulation_env/Dockerfile, tail) but ships no
environment code — the env zoo is a capability of its *image*, not its
codebase.  This module is that capability's first-class counterpart: any
task from those suites, adapted to the COBOTTA observation schema the
whole framework speaks (``image_horizon`` [S, S, 3] uint8, ``sound``
[128, 20] float32 log-STFT, ``pose_quat_v2`` [3] float32 in ~[-1, 1]),
behind the envs package's duck-typed reset/step protocol
(multimodal_rssm_torch/envs/__init__.py) — so the scripted collector, the
online trainer (train/online.py) and the world model run on external
tasks unchanged.

All suite imports are lazy: constructing an adapter for a missing suite
raises a clear ImportError; everything else in this module is
numpy-only.  Each adapter also accepts a pre-built ``env=`` object so the
conversion logic is testable without the suites installed
(tests/test_torch_port_online.py drives them with duck-typed fakes).

Schema notes:

- Frames are converted to the model's input size with a nearest-neighbour
  resize (no cv2/PIL dependency; encoders only need a consistent raster).
- ``pose_quat_v2`` is ``tanh`` of the first 3 proprioceptive dimensions —
  scale-free squashing into the range the pose encoders were calibrated
  on (data/pose.py v2 convention keeps poses in ~[-1, 1]).
- External suites have no contact microphone, so the sound channel is a
  *synthesized contact trace*: per control step the adapter appends a
  short tone burst whose amplitude and frequency are keyed to a
  task-meaningful scalar (contact force where the suite exposes physics,
  |reward| otherwise), then takes the same trailing log-STFT as the
  MuJoCo peg env (envs/peg.py::spectrogram).  The spectrogram therefore
  carries real task state — it is a modality, not padding.
"""

from typing import Dict, Optional, Sequence

import numpy as np

from multimodal_rssm_torch.envs.peg import spectrogram

OBSERVATION_NAMES = ("image_horizon", "sound", "pose_quat_v2")

# samples appended to the contact trace per control step; 46 steps fill
# the spectrogram's trailing window (win 256 + hop 64 * 19 = 1472)
SIGNAL_RATE = 32


def resize_frame(frame: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour resize of an [H, W, 3] uint8 frame to
    [size, size, 3].  Index-array gather — exact for identity, cheap and
    dependency-free otherwise."""
    frame = np.asarray(frame)
    if frame.ndim != 3 or frame.shape[2] < 3:
        raise ValueError(f"expected [H, W, >=3] frame, got {frame.shape}")
    frame = frame[..., :3]
    if frame.dtype != np.uint8:
        frame = (np.clip(frame, 0.0, 1.0) * 255).astype(np.uint8)
    h, w = frame.shape[:2]
    if (h, w) == (size, size):
        return frame
    rows = (np.arange(size) * (h / size)).astype(np.intp)
    cols = (np.arange(size) * (w / size)).astype(np.intp)
    return frame[rows[:, None], cols[None, :]]


def pose_vector(values: Sequence[float], dim: int = 3) -> np.ndarray:
    """First ``dim`` proprioceptive entries squashed to ~[-1, 1]
    (tanh — scale-free, monotone), zero-padded when shorter."""
    flat = np.asarray(values, np.float32).ravel()[:dim]
    out = np.zeros(dim, np.float32)
    out[: flat.size] = np.tanh(flat)
    return out


def flatten_observation(obs) -> np.ndarray:
    """Concatenate a suite observation (vector, scalar, or dict of
    arrays in sorted-key order) into one float32 vector, skipping
    image-like (>=2-D, wide) entries."""
    if isinstance(obs, dict):
        parts = []
        for key in sorted(obs):
            value = np.asarray(obs[key])
            if value.ndim >= 2 and min(value.shape[:2]) > 8:
                continue  # camera planes are not proprioception
            parts.append(value.astype(np.float32).ravel())
        return (
            np.concatenate(parts) if parts else np.zeros(1, np.float32)
        )
    return np.asarray(obs, np.float32).ravel()


class ContactTrace:
    """The synthesized contact-microphone stream (module docstring)."""

    def __init__(self):
        self.signal = []
        self._phase = 0.0

    def reset(self):
        self.signal = []
        self._phase = 0.0

    def push(self, value: float):
        amp = float(np.tanh(abs(value)))
        freq = 2.0 + 6.0 * amp  # cycles per burst: loud contact -> higher
        t = np.arange(SIGNAL_RATE, dtype=np.float32) / SIGNAL_RATE
        burst = amp * np.sin(
            2.0 * np.pi * (freq * t + self._phase)
        )
        self._phase = (self._phase + freq) % 1.0  # phase-continuous
        self.signal.extend(burst.tolist())
        if len(self.signal) > 4096:
            del self.signal[:-4096]

    def spectrogram(self) -> np.ndarray:
        return spectrogram(self.signal)


class _AdapterBase:
    """Shared observe/termination plumbing; subclasses implement the
    suite-specific _raw_reset/_raw_step returning (frame, proprio,
    contact_scalar, reward, done)."""

    observation_names = OBSERVATION_NAMES
    action_name = "d_pose_quat_v2"

    def __init__(self, length: int, render_size: int):
        self.length = int(length)
        self.render_size = int(render_size)
        self.trace = ContactTrace()
        self.t = 0

    def reset(self, seed=None) -> Dict[str, np.ndarray]:
        self.trace.reset()
        self.t = 0
        frame, proprio = self._raw_reset(seed)
        return self._observe(frame, proprio)

    def step(self, action):
        action = np.clip(
            np.asarray(action, np.float32).ravel(), -1.0, 1.0
        )
        frame, proprio, contact, reward, done = self._raw_step(action)
        self.trace.push(contact)
        self.t += 1
        if self.t >= self.length:
            done = True
        return self._observe(frame, proprio), float(reward), bool(done)

    def _observe(self, frame, proprio) -> Dict[str, np.ndarray]:
        return {
            "image_horizon": resize_frame(frame, self.render_size),
            "sound": self.trace.spectrogram(),
            "pose_quat_v2": pose_vector(proprio),
        }


def _map_to_box(action: np.ndarray, low, high) -> np.ndarray:
    """Affine [-1, 1]^k -> [low, high]; non-finite bounds pass through."""
    low = np.asarray(low, np.float32).ravel()
    high = np.asarray(high, np.float32).ravel()
    k = low.size
    a = np.zeros(k, np.float32)
    a[: min(k, action.size)] = action[:k]
    finite = np.isfinite(low) & np.isfinite(high)
    # compute the affine arm on finite bounds only (inf-inf is NaN)
    lo = np.where(finite, low, 0.0)
    hi = np.where(finite, high, 0.0)
    out = np.where(finite, lo + (a + 1.0) * 0.5 * (hi - lo), a)
    return out.astype(np.float32)


class GymAdapter(_AdapterBase):
    """gym / gymnasium tasks.  Handles both API generations: 4- and
    5-tuple ``step``, ``reset`` with/without the (obs, info) pair, Box
    (affine-mapped) and Discrete (argmax-binned) action spaces.  Frames
    come from ``render()`` (construct with ``render_mode='rgb_array'``);
    envs without rgb rendering get a zero frame and remain usable as
    sound+pose tasks."""

    def __init__(self, env_id: Optional[str] = None, length: int = 100,
                 render_size: int = 64, seed: int = 0, env=None):
        super().__init__(length, render_size)
        self.env = env if env is not None else _make_gym(env_id)
        space = getattr(self.env, "action_space", None)
        self._discrete_n = getattr(space, "n", None)
        if self._discrete_n is not None:
            self.action_size = int(self._discrete_n)
        else:
            self._low = getattr(space, "low", np.array([-1.0]))
            self._high = getattr(space, "high", np.array([1.0]))
            self.action_size = int(np.asarray(self._low).size)
        self._seed = seed
        self.reset(seed)

    def _raw_reset(self, seed):
        try:
            result = self.env.reset(seed=seed)
        except TypeError:  # old gym: no seed kwarg
            result = self.env.reset()
        obs = result[0] if isinstance(result, tuple) else result
        return self._frame(), flatten_observation(obs)

    def _raw_step(self, action):
        if self._discrete_n is not None:
            env_action = int(np.argmax(action[: self._discrete_n]))
        else:
            env_action = _map_to_box(action, self._low, self._high)
        result = self.env.step(env_action)
        if len(result) == 5:  # gymnasium
            obs, reward, terminated, truncated, _ = result
            done = bool(terminated) or bool(truncated)
        else:  # classic gym
            obs, reward, done, _ = result
        proprio = flatten_observation(obs)
        # contact proxy: |reward| (suite physics is not exposed uniformly)
        return self._frame(), proprio, abs(float(reward)), reward, done

    def _frame(self):
        try:
            frame = self.env.render()
        except Exception:
            frame = None
        if frame is None:
            return np.zeros(
                (self.render_size, self.render_size, 3), np.uint8
            )
        return np.asarray(frame)


class DMControlAdapter(_AdapterBase):
    """dm_control suite tasks (``dmc:<domain>:<task>``).  Steps the
    dm_env TimeStep protocol; frames via ``physics.render``; the contact
    scalar is the summed substep contact-force magnitude from the
    underlying MuJoCo physics — a real contact microphone, like the peg
    env's."""

    def __init__(self, domain: Optional[str] = None,
                 task: Optional[str] = None, length: int = 100,
                 render_size: int = 64, seed: int = 0, env=None):
        super().__init__(length, render_size)
        if env is None:
            from dm_control import suite  # lazy: suite optional

            env = suite.load(
                domain, task, task_kwargs={"random": seed}
            )
        self.env = env
        spec = self.env.action_spec()
        self._low = np.asarray(spec.minimum, np.float32).ravel()
        self._high = np.asarray(spec.maximum, np.float32).ravel()
        self.action_size = int(self._low.size)
        self.reset(seed)

    def _raw_reset(self, seed):
        ts = self.env.reset()
        return self._frame(), flatten_observation(ts.observation)

    def _raw_step(self, action):
        ts = self.env.step(_map_to_box(action, self._low, self._high))
        reward = 0.0 if ts.reward is None else float(ts.reward)
        return (
            self._frame(),
            flatten_observation(ts.observation),
            self._contact(),
            reward,
            ts.last(),
        )

    def _frame(self):
        physics = getattr(self.env, "physics", None)
        if physics is None:
            return np.zeros(
                (self.render_size, self.render_size, 3), np.uint8
            )
        try:
            return physics.render(
                height=self.render_size, width=self.render_size,
                camera_id=0,
            )
        except Exception:  # GL-less container
            return np.zeros(
                (self.render_size, self.render_size, 3), np.uint8
            )

    def _contact(self) -> float:
        physics = getattr(self.env, "physics", None)
        data = getattr(physics, "data", None)
        cfrc = getattr(data, "cfrc_ext", None)
        if cfrc is None:
            return 0.0
        return float(np.sum(np.abs(np.asarray(cfrc))))


class RobosuiteAdapter(_AdapterBase):
    """robosuite manipulation tasks (``robosuite:<Task>``).  Uses the
    offscreen agentview camera (robosuite frames arrive upside down —
    flipped here), the robot proprio-state vector for pose, and the
    end-effector force-torque reading as the contact scalar."""

    def __init__(self, task: Optional[str] = None, robots: str = "Panda",
                 length: int = 100, render_size: int = 64, seed: int = 0,
                 env=None):
        super().__init__(length, render_size)
        if env is None:
            import robosuite  # lazy: suite optional

            env = robosuite.make(
                task,
                robots=robots,
                has_renderer=False,
                has_offscreen_renderer=True,
                use_camera_obs=True,
                camera_names="agentview",
                camera_heights=render_size,
                camera_widths=render_size,
                horizon=length,
                ignore_done=False,
            )
        self.env = env
        low, high = self.env.action_spec
        self._low = np.asarray(low, np.float32).ravel()
        self._high = np.asarray(high, np.float32).ravel()
        self.action_size = int(self._low.size)
        np.random.seed(seed)  # robosuite draws placement from global RNG
        self.reset(seed)

    def _raw_reset(self, seed):
        obs = self.env.reset()
        return self._frame(obs), self._proprio(obs)

    def _raw_step(self, action):
        obs, reward, done, _ = self.env.step(
            _map_to_box(action, self._low, self._high)
        )
        return (
            self._frame(obs),
            self._proprio(obs),
            self._contact(obs),
            reward,
            done,
        )

    def _frame(self, obs):
        frame = obs.get("agentview_image")
        if frame is None:
            return np.zeros(
                (self.render_size, self.render_size, 3), np.uint8
            )
        return np.asarray(frame)[::-1]  # OpenGL origin: flip vertically

    @staticmethod
    def _proprio(obs):
        vec = obs.get("robot0_proprio-state")
        return flatten_observation(vec if vec is not None else obs)

    @staticmethod
    def _contact(obs) -> float:
        ft = obs.get("robot0_eef_force", obs.get("robot0_ee_force"))
        if ft is None:
            return 0.0
        return float(np.linalg.norm(np.asarray(ft, np.float64)))


def make_zoo_env(spec: str, length: int = 100, render_size: int = 64,
                 seed: int = 0, env=None):
    """Dispatch an external-suite spec:

    - ``gym:<env_id>``          e.g. ``gym:Pendulum-v1``
    - ``dmc:<domain>:<task>``   e.g. ``dmc:cartpole:swingup``
    - ``robosuite:<Task>``      e.g. ``robosuite:Lift`` (or
      ``robosuite:<Task>:<Robot>``)
    """
    kind, _, rest = spec.partition(":")
    if not rest:
        raise ValueError(
            f"malformed env spec '{spec}' (expected '<suite>:<task>')"
        )
    if kind == "gym":
        return GymAdapter(rest, length=length, render_size=render_size,
                          seed=seed, env=env)
    if kind == "dmc":
        domain, _, task = rest.partition(":")
        if not task:
            raise ValueError(
                f"malformed dmc spec '{spec}' (expected 'dmc:domain:task')"
            )
        return DMControlAdapter(domain, task, length=length,
                                render_size=render_size, seed=seed,
                                env=env)
    if kind == "robosuite":
        task, _, robots = rest.partition(":")
        kwargs = {"robots": robots} if robots else {}
        return RobosuiteAdapter(task, length=length,
                                render_size=render_size, seed=seed,
                                env=env, **kwargs)
    raise ValueError(
        f"unknown env suite '{kind}' (expected gym | dmc | robosuite)"
    )


def _make_gym(env_id: str):
    """gymnasium preferred, classic gym fallback; rgb_array rendering
    requested when the registry supports it."""
    try:
        import gymnasium as gym_mod
    except ImportError:
        try:
            import gym as gym_mod
        except ImportError as exc:
            raise ImportError(
                "GymAdapter needs gymnasium or gym installed "
                "(docker --build-arg SIM=1 image ships gymnasium)"
            ) from exc
    try:
        return gym_mod.make(env_id, render_mode="rgb_array")
    except TypeError:
        return gym_mod.make(env_id)
