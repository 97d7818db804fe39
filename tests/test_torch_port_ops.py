"""PyTorch port, ops: the bit-depth-normalise kernel's plain version and the
Gaussian / fusion / image functions, held against the JAX package.

Inputs come from numpy with a seed and go to both packages as arrays.
Tolerances:
- the normalise is exact: the JAX kernel runs in the Pallas interpreter,
  whose random bits are stubbed to zero, so it is the quantised part alone,
  and the port's output must equal it plus the port's noise bit for bit;
- elementwise functions at rtol 1e-6: the same float32 formulas, evaluated
  by two libraries that may fuse or order them differently.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multimodal_rssm_tpu.losses import elbo as jelbo
from multimodal_rssm_tpu.ops import fusion as jfusion
from multimodal_rssm_tpu.ops import gaussian as jgauss
from multimodal_rssm_tpu.ops import image as jimage
from multimodal_rssm_tpu.ops.pallas_kernels import normalize_image_pallas

from multimodal_rssm_torch.losses import elbo
from multimodal_rssm_torch.ops import cuda_kernels as ck
from multimodal_rssm_torch.ops import fusion, gaussian, image

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _philox_reference(g: int, seed: int):
    """Philox4x32-10 on Python integers (Salmon et al., SC'11)."""
    m = 0xFFFFFFFF
    c = [g & m, (g >> 32) & m, 0, 0]
    k = [seed & m, (seed >> 32) & m]
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & m, (k[1] + 0xBB67AE85) & m]
        p0 = 0xD2511F53 * c[0]
        p1 = 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & m, (p0 >> 32) ^ c[3] ^ k[1], p0 & m]
    return c


# -- K1: the bit-depth normalise -----------------------------------------------


def test_philox_plain_matches_integer_reference():
    seed = (1 << 62) + 987654321
    groups = [0, 1, 2, 3, 255, 2 ** 32 - 1, 2 ** 32 + 5, 7_680_000]
    got = ck.philox4x32_10(torch.tensor(groups), torch.tensor(seed)).tolist()
    assert got == [_philox_reference(g, seed) for g in groups]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_normalize_plain_matches_jax_kernel(dtype):
    """The JAX Pallas kernel (interpreted: random bits stubbed to zero) is
    the quantised part; the port's output is exactly that plus the port's
    own noise, for uint8 and float32 input."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, size=(2, 4, 64, 64, 3)).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(normalize_image_pallas(
            jnp.asarray(img), 5, jnp.asarray([7], jnp.int32)))
    seed = torch.tensor(7)
    got = ck.normalize_image(_t(img), 5, seed)
    noise = ck.normalize_noise_plain(img.size, 5, seed).reshape(img.shape)
    np.testing.assert_array_equal(got.numpy(), (_t(want) + noise).numpy())
    np.testing.assert_array_equal(
        got.numpy(), ck.normalize_image_plain(_t(img), 5, seed).numpy())


def test_normalize_noise_range_and_moments():
    """u / 2^b is uniform on [0, 1/32): mean 1/64, std 1/(32 sqrt 12)
    (±1e-4 at 1.2 M draws: 10+ standard errors of each moment)."""
    n = 1_228_800
    noise = ck.normalize_noise_plain(n, 5, torch.tensor(3)).double()
    assert float(noise.min()) >= 0.0 and float(noise.max()) < 1 / 32
    assert abs(float(noise.mean()) - 1 / 64) < 1e-4
    assert abs(float(noise.std()) - 1 / 32 / np.sqrt(12)) < 1e-4


def test_normalize_seed_determinism():
    rng = np.random.default_rng(2)
    x = _t(rng.integers(0, 256, size=(3, 2, 64, 64, 3)).astype(np.float32))
    a = ck.normalize_image(x, 5, torch.tensor(11))
    assert torch.equal(a, ck.normalize_image(x, 5, torch.tensor(11)))
    b = ck.normalize_image(x, 5, torch.tensor(12))
    assert float((a != b).float().mean()) > 0.99


def test_normalize_wrapper_cpu_takes_plain_and_validates():
    """A CPU tensor runs the plain version, so no launch is counted; no
    element-count rule (the TPU kernel needed a multiple of 512)."""
    ck.reset_launch_counts()
    x = torch.arange(0, 255, 3, dtype=torch.float32)[:77]
    out = ck.normalize_image(x, 5, torch.tensor(5))
    assert out.shape == x.shape and out.dtype == torch.float32
    assert ck.launch_counts() == dict.fromkeys(ck.KERNELS, 0)
    with pytest.raises(TypeError):
        ck.normalize_image(x.double(), 5, torch.tensor(5))
    with pytest.raises(ValueError):
        ck.normalize_image(x, 9, torch.tensor(5))
    with pytest.raises(TypeError):
        ck.normalize_image(x, 5, torch.tensor(5.0))


# -- gaussian / fusion / image ---------------------------------------------------


def _gauss_inputs(shape=(3, 5, 7)):
    rng = np.random.default_rng(4)
    return [rng.normal(size=shape).astype(np.float32),
            (np.abs(rng.normal(size=shape)) + 0.1).astype(np.float32),
            rng.normal(size=shape).astype(np.float32),
            (np.abs(rng.normal(size=shape)) + 0.1).astype(np.float32)]


@pytest.mark.parametrize("fn", ["rsample", "log_prob", "kl_normal",
                                "kl_standard_normal"])
def test_gaussian_matches_jax(fn):
    m, s, m2, s2 = _gauss_inputs()
    args = {"rsample": (m, s, m2), "log_prob": (m, s, m2),
            "kl_normal": (m, s, m2, s2), "kl_standard_normal": (m, s)}[fn]
    want = np.asarray(getattr(jgauss, fn)(*map(jnp.asarray, args)))
    got = getattr(gaussian, fn)(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize("method", ["MoPoE", "PoE", "NN"])
def test_fusion_matches_jax(method):
    rng = np.random.default_rng(5)
    means = rng.normal(size=(3, 4, 2, 13)).astype(np.float32)
    stds = (np.abs(rng.normal(size=(3, 4, 2, 13))) + 0.1).astype(np.float32)
    want = jfusion.fuse(method, jnp.asarray(means), jnp.asarray(stds))
    got = fusion.fuse(method, _t(means), _t(stds))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)
    wm, ws = jfusion.subset_poe_states(jnp.asarray(means), jnp.asarray(stds))
    gm, gs = fusion.subset_poe_states(_t(means), _t(stds))
    for g, w in zip(gm + gs, wm + ws):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL)


def test_fusion_static_structure_matches_jax():
    for m in range(4):
        assert fusion.enumerate_subsets(m) == jfusion.enumerate_subsets(m)
    for s, k in ((128, 4), (13, 4), (16, 8)):
        assert fusion.mopoe_partition(s, k) == jfusion.mopoe_partition(s, k)


def test_poe_weights_by_inverse_std():
    """The reference's PoE precision is 1/std (not 1/var)."""
    mean, std = fusion.poe(torch.tensor([[0.0], [3.0]]),
                           torch.tensor([[1.0], [2.0]]))
    assert torch.allclose(mean, torch.tensor([1.0]))        # (0 + 1.5) / 1.5
    assert torch.allclose(std, torch.tensor([1.0 / 1.5]))


@pytest.mark.parametrize("case", ["obs_mse", "obs_logp", "reward_mse",
                                  "reward_nll", "kl_plain", "kl_balanced",
                                  "mopoe_kl", "global_kl"])
def test_elbo_terms_match_jax(case):
    """Each ELBO term's value, and for the KLs the gradient with respect to
    the posterior and prior means (where KL balancing's stop-gradients
    show), at rtol 1e-6 (float32 reductions ordered by each library)."""
    m, s, m2, s2 = _gauss_inputs((4, 2, 6))
    experts = np.stack([m, m2, m + m2]).transpose(1, 0, 2, 3)      # [T, K, B, S]
    expert_stds = np.stack([s, s2, s + s2]).transpose(1, 0, 2, 3)
    per_elem = {"a": m * m, "b": s[..., :3]}
    calls = {
        "obs_mse": (lambda E, x: E.observation_losses(x, False), (per_elem,)),
        "obs_logp": (lambda E, x: E.observation_losses(x, True), (per_elem,)),
        "reward_mse": (lambda E, *a: E.reward_loss(*a, False),
                       (m[..., 0], s[..., 0], m2[..., 0])),
        "reward_nll": (lambda E, *a: E.reward_loss(*a, True),
                       (m[..., 0], s[..., 0], m2[..., 0])),
        "kl_plain": (lambda E, *a: E.kl_balanced(*a, None, 0.5), (m, s, m2, s2)),
        "kl_balanced": (lambda E, *a: E.kl_balanced(*a, 0.8, 0.5),
                        (m, s, m2, s2)),
        "mopoe_kl": (lambda E, *a: E.mopoe_kl(*a, 0.5),
                     (experts, expert_stds, m2, s2)),
        "global_kl": (lambda E, *a: E.global_kl(*a), (m, s)),
    }
    fn, args = calls[case]
    want = fn(jelbo, *jax.tree_util.tree_map(jnp.asarray, args))
    targs = jax.tree_util.tree_map(lambda a: _t(a).requires_grad_(), args)
    got = fn(elbo, *targs)
    if isinstance(want, dict):
        for k in want:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), rtol=RTOL)
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL)
    if "kl" in case and case != "global_kl":
        wgrads = jax.grad(lambda a, c: fn(jelbo, a, args[1], c, *args[3:]),
                          argnums=(0, 1))(*map(jnp.asarray, (args[0], args[2])))
        ggrads = torch.autograd.grad(got, (targs[0], targs[2]))
        for g, w in zip(ggrads, wgrads):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=1e-8)


def test_image_functions_match_jax():
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, size=(2, 3, 64, 64, 3)).astype(np.uint8)
    for bits in (3, 5, 8):
        want = np.asarray(jimage.normalize_image_deterministic(
            jnp.asarray(img), bits))
        got = image.normalize_image_deterministic(_t(img), bits).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
        obs = rng.uniform(-0.5, 0.5, size=(4, 8, 8, 3)).astype(np.float32)
        np.testing.assert_array_equal(image.reverse_normalized_image(obs, bits),
                                      jimage.reverse_normalized_image(obs, bits))
    gen = torch.Generator().manual_seed(0)
    noisy = image.normalize_image(_t(img), 5, gen)
    det = image.normalize_image_deterministic(_t(img), 5)
    noise = noisy - det
    assert float(noise.min()) >= 0 and float(noise.max()) < 1 / 32 + 1e-6
