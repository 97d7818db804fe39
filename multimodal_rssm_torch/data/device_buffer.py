"""Device-resident replay: the loaded rows live on the training device and
each step gathers its chunks there.

Fed from the host, a step at batch 50 x chunk 50 costs a ~55 MB gather on
the host and a copy over the host link.  When the dataset fits the device
budget (``hbm_budget_bytes``), ``DeviceReplay`` uploads it once and a step
receives only its [n, L] index matrix (20 KB of int64); ``gather_batch``
then gathers at device-memory rate.  A dataset over the budget keeps a
working set of whole segments resident (``StreamingDeviceReplay``),
refreshed a few segments at a time.

Rows are stored flat, ``[rows, prod(row shape)]`` per modality, with
``row_shapes`` to restore them: the layout the JAX package's device replay
uses, kept so both give the same arrays and index contract.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

# What a run needs on the card beside the replay once the model is there,
# measured at batch 50 x chunk 50 (bf16 autocast, full width) by
# chip_smoke.py's budget phase on an NVIDIA H100 80GB HBM3, 700 W: 37.85
# GiB, of which the step's and an async checkpoint's peak reserved by the
# caching allocator is 36.55 GiB (32.84 GiB of it allocated) and cuBLAS /
# cuDNN take 1.29 GiB outside the allocator at the first step.  40 GiB
# leaves 2.15 GiB for fragmentation; a replay at a 36.1 GiB reserve ran out
# of memory at step 3.
# A rank of a data-parallel run keeps the same 40 GiB: no run has yet
# filled a rank's budget with replay and stepped at a smaller local batch,
# and a rank adds memory a single process lacks (the collectives' buffers,
# the flat gradient copy of ``all_reduce_mean_``).
_DEFAULT_RESERVE_BYTES = 40 << 30
_MIN_BUDGET_BYTES = 2 << 30
_CPU_BUDGET_BYTES = 4 << 30
# Bytes a step holds per image-codec activation element of a sample beyond
# the default configuration's one 64 px image codec (the input, the conv /
# ConvT outputs, the norms' and activations' saved tensors, and the
# float32 target and mean).  chip_smoke.py's budget phase on an NVIDIA
# H100 80GB HBM3, 700 W: the 256 px GroupNorm step needs 61.66 GiB beside
# its replay, the default 37.08 GiB, over 2,450 x 983,336 more elements:
# 10.96 bytes each.  12 leaves that run 5.26 GiB of margin at 66.92 GiB.
_BYTES_PER_CODEC_ELEMENT = 12


def hbm_budget_bytes(device: torch.device,
                     reserve_bytes: int = _DEFAULT_RESERVE_BYTES,
                     sharing: int = 1) -> int:
    """Bytes of replay the device may hold.

    ``MRSSM_REPLAY_BUDGET_GB`` overrides.  On a CUDA device: the free bytes
    (``torch.cuda.mem_get_info``; a share of them where ``sharing`` ranks
    use the card) minus ``reserve_bytes`` for the step, never below 2 GiB.
    On the CPU (the tests): a fixed 4 GiB, so a CPU run takes the same
    ``auto`` decisions as the JAX package's tests."""
    env = os.environ.get("MRSSM_REPLAY_BUDGET_GB")
    if env:
        return int(float(env) * (1 << 30))
    if device.type != "cuda":
        return _CPU_BUDGET_BYTES
    free, _ = torch.cuda.mem_get_info(device)
    return max(_MIN_BUDGET_BYTES,
               int(free) // max(1, int(sharing)) - int(reserve_bytes))


def image_codec_elements(shape) -> int:
    """Activation elements of one sample through an image modality's codec
    at ``shape`` (C, H, W): the image, every encoder conv's output and
    every decoder ConvT's output."""
    from multimodal_rssm_torch.models.decoders import IMAGE_DECODERS
    from multimodal_rssm_torch.models.encoders import IMAGE_ENCODERS

    c, size = int(shape[0]), int(shape[1])
    n, hw = c * size * size, size
    for features, k, s in IMAGE_ENCODERS[size].layer_defs:
        hw = (hw - k) // s + 1
        n += features * hw * hw
    hw = 1
    for features, k, s in IMAGE_DECODERS[size].layer_defs:
        hw = (hw - 1) * s + k
        n += (features or c) * hw * hw
    return n


def step_reserve_bytes(cfg, ranks: int = 1) -> int:
    """The reserve ``hbm_budget_bytes`` keeps for the configured step: the
    default configuration's measured 40 GiB, plus ``_BYTES_PER_CODEC_ELEMENT``
    per image-codec activation element that the configured image
    modalities add over one 64 px codec, for each sample of a micro-batch
    (batch x (chunk - 1) / ``train.grad_accum``).  Over ``ranks`` data
    ranks a step holds batch / ``ranks`` rows: the per-sample charge
    shrinks with it, the measured 40 GiB does not."""
    rssm = cfg.rssm
    shapes = cfg.env.observation_shapes
    names = set(rssm.observation_names_enc) | set(rssm.observation_names_rec)
    if not bool(rssm.get("multimodal", True)):
        names = {rssm.observation_names_enc[0], rssm.observation_names_rec[0]}
    elements = sum(image_codec_elements(shapes[n]) for n in names
                   if "image" in n)
    extra = max(0, elements - image_codec_elements((3, 64, 64)))
    accum = int(cfg.train.get("grad_accum", 1) or 1)
    ranks = max(1, int(ranks))
    local = int(cfg.train.batch_size) // ranks
    samples = local * (int(cfg.train.chunk_size) - 1)
    return (_DEFAULT_RESERVE_BYTES
            + samples // accum * extra * _BYTES_PER_CODEC_ELEMENT)


def _used_rows(host_buffer) -> int:
    return host_buffer.size if host_buffer.full else host_buffer.idx


def _host_views(host_buffer, used: int) -> Dict[str, np.ndarray]:
    """Every stored array's first ``used`` rows, by the flat arrays' keys."""
    views = {name: host_buffer.observations[name][:used]
             for name in host_buffer.observation_names}
    views["__actions__"] = host_buffer.actions[:used]
    views["__rewards__"] = host_buffer.rewards[:used].reshape(used, 1)
    views["__nonterminals__"] = host_buffer.nonterminals[:used]
    return views


def _row_shapes(host_buffer) -> Dict[str, tuple]:
    shapes = {name: tuple(host_buffer.observations[name].shape[1:])
              for name in host_buffer.observation_names}
    shapes["__actions__"] = tuple(host_buffer.actions.shape[1:])
    shapes["__rewards__"] = ()
    shapes["__nonterminals__"] = tuple(host_buffer.nonterminals.shape[1:])
    return shapes


def _flat(rows: np.ndarray) -> np.ndarray:
    return rows.reshape(rows.shape[0], -1)


def indices_to_device(idxs: np.ndarray, device: torch.device) -> torch.Tensor:
    """An [n, L] index matrix as int64 on ``device``: a pinned,
    non-blocking copy on a GPU (the pinned block is not reused before the
    copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(idxs, np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class DeviceReplay:
    """The loaded rows of a host ``ExperienceReplay``, on ``device``."""

    def __init__(self, host_buffer, device: torch.device):
        used = _used_rows(host_buffer)
        self.host = host_buffer
        self.used = used
        self.device = device
        self.row_shapes = _row_shapes(host_buffer)
        self.arrays: Dict[str, torch.Tensor] = {
            k: torch.from_numpy(np.ascontiguousarray(_flat(v))).to(device)
            for k, v in _host_views(host_buffer, used).items()}

    @staticmethod
    def nbytes(host_buffer) -> int:
        return sum(v.nbytes for v in
                   _host_views(host_buffer, _used_rows(host_buffer)).values())

    @staticmethod
    def fits(host_buffer, budget_bytes: int) -> bool:
        return DeviceReplay.nbytes(host_buffer) <= budget_bytes

    def sample_indices(self, n: int, L: int,
                       rows: Optional[np.ndarray] = None) -> torch.Tensor:
        """[n, L] chunk indices, drawn as the host buffer draws them
        (``rows``: only these rows of the matrix go to the device)."""
        idxs = self.host.sample_indices(n, L)
        return indices_to_device(idxs if rows is None else idxs[rows],
                                 self.device)


class StreamingDeviceReplay:
    """A device-resident working set for a dataset over the budget.

    ``W`` slots of ``S`` contiguous host rows stay resident, flat
    ``[W * S, ...]`` per modality (``DeviceReplay``'s layout, so the same
    step gathers from either).  A step samples chunks inside resident
    segments; ``refresh()`` replaces a few slots with fresh uniformly drawn
    host segments.  Each slot holds a uniform draw of the host segments, so
    the marginal distribution over buffer rows stays uniform; chunks never
    cross a segment boundary, and within one step they come from the
    working set.  The same NumPy draws in the same order as the JAX
    package's class: one seed and budget give the same residency, indices
    and arrays.

    A refresh copies each array's segment rows into a pinned staging
    buffer, then into the slot on the current stream.  Stream order puts
    the copy after every step queued before it, so it never overwrites rows
    a queued step still gathers; and the step after it sees the new rows.
    Two staging buffers alternate, each with an event: a buffer is refilled
    only once its previous copy has run.
    """

    _STAGING = 2

    def __init__(self, host_buffer, chunk_size: int, device: torch.device,
                 budget_bytes: int, segment_len: Optional[int] = None,
                 refresh_segments: int = 1, seed: int = 0):
        used = _used_rows(host_buffer)
        self.host = host_buffer
        self.used = used
        self.device = device
        self.refresh_segments = int(refresh_segments)
        self.rng = np.random.default_rng(seed)

        L = int(chunk_size)
        S = int(segment_len) if segment_len else 4 * L
        if S < L:
            raise ValueError(f"segment_len {S} < chunk_size {L}")
        self.S = S
        self.n_host_segments = used // S
        if self.n_host_segments < 2:
            raise ValueError(
                f"dataset too small to stream: {used} rows < 2 segments "
                f"of {S} — use DeviceReplay")
        row_bytes = DeviceReplay.nbytes(host_buffer) / max(used, 1)
        W = int(budget_bytes // (S * row_bytes))
        self.W = max(2, min(W, self.n_host_segments))

        self.resident = self.rng.choice(self.n_host_segments, size=self.W,
                                        replace=False)
        self.row_shapes = _row_shapes(host_buffer)
        self._views = {k: _flat(v)
                       for k, v in _host_views(host_buffer, used).items()}
        self.arrays: Dict[str, torch.Tensor] = {
            k: torch.from_numpy(np.concatenate(
                [v[seg * S:(seg + 1) * S] for seg in self.resident])).to(device)
            for k, v in self._views.items()}
        self._staging = []
        if device.type == "cuda":
            self._staging = [
                ({k: torch.empty((S, v.shape[1]), dtype=self.arrays[k].dtype,
                                 pin_memory=True)
                  for k, v in self._views.items()}, torch.cuda.Event())
                for _ in range(self._STAGING)]
        self._next_staging = 0

    def sample_indices(self, n: int, L: int,
                       rows: Optional[np.ndarray] = None) -> torch.Tensor:
        """[n, L] chunk indices into the flat [W * S] working set: a
        uniform slot, a uniform start in [0, S - L] (``rows``: only these
        rows of the matrix go to the device)."""
        slots = self.rng.integers(0, self.W, size=n)
        offsets = self.rng.integers(0, self.S - L + 1, size=n)
        starts = slots * self.S + offsets
        if rows is not None:
            starts = starts[rows]
        return indices_to_device(starts[:, None] + np.arange(L)[None, :],
                                 self.device)

    def refresh(self, n_segments: Optional[int] = None) -> int:
        """Replace ``n_segments`` (default ``refresh_segments``) random
        slots with fresh uniform host segments; returns the bytes queued."""
        n = self.refresh_segments if n_segments is None else int(n_segments)
        total = 0
        for _ in range(n):
            slot = int(self.rng.integers(0, self.W))
            seg = int(self.rng.integers(0, self.n_host_segments))
            total += self._load(slot, seg)
        return total

    def _load(self, slot: int, seg: int) -> int:
        """Queue the copy of host segment ``seg`` into ``slot``; returns its
        bytes."""
        S, total = self.S, 0
        self.resident[slot] = seg
        if self._staging:
            staging, done = self._staging[self._next_staging]
            self._next_staging = (self._next_staging + 1) % self._STAGING
            done.synchronize()
        for k, view in self._views.items():
            rows = view[seg * S:(seg + 1) * S]
            total += rows.nbytes
            dst = self.arrays[k][slot * S:(slot + 1) * S]
            if self._staging:
                staging[k].numpy()[...] = rows
                dst.copy_(staging[k], non_blocking=True)
            else:
                dst.copy_(torch.from_numpy(rows))
        if self._staging:
            done.record()
        return total

    def state(self) -> Dict:
        """The generator's state and the resident segments, for a
        checkpoint."""
        return {"rng": self.rng.bit_generator.state,
                "resident": [int(s) for s in self.resident]}

    def set_state(self, state: Dict) -> None:
        """Continue from ``state()``: the generator, and every slot whose
        segment differs reloaded."""
        if len(state["resident"]) != self.W:
            raise ValueError(f"a working set of {len(state['resident'])} "
                             f"segments cannot continue in {self.W} slots")
        self.rng.bit_generator.state = state["rng"]
        for slot, seg in enumerate(state["resident"]):
            if int(self.resident[slot]) != int(seg):
                self._load(slot, int(seg))


def gather_batch(arrays: Dict[str, torch.Tensor], idxs: torch.Tensor,
                 observation_names, row_shapes: Dict[str, tuple]
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                            torch.Tensor, torch.Tensor]:
    """Time-major chunk gather on the device: idxs [n, L] -> the host
    buffer's batch layout (observations {name: [L, n, ...]}, actions
    [L, n, A], rewards [L, n], nonterminals [L, n, 1]).  The rows are
    taken in (l, i) order, so each leaf comes out contiguous."""
    n, L = idxs.shape
    flat = idxs.T.reshape(-1)

    def take(key):
        return arrays[key].index_select(0, flat).view(L, n, *row_shapes[key])

    return ({name: take(name) for name in observation_names},
            take("__actions__"), take("__rewards__"), take("__nonterminals__"))
