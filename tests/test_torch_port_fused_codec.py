"""PyTorch port, the fused conv + InstanceNorm + GLU op (K2 forward, K3a-c
backward): the port against the JAX package's ``conv_in_glu`` run in the
Pallas interpreter, in f32 on the CPU, where each wrapper takes its plain
version.

Inputs come from numpy with a seed and go to both packages as arrays.
Tolerances (the JAX op's own tests' tolerances):
- forward values and stats at rtol 1e-4 / atol 1e-5;
- gradients at rtol 2e-4 / atol 2e-4: f32 sums of thousands of products,
  taken in another order by the two libraries.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_fused_codec import CASES, ref_conv_in_glu

from multimodal_rssm_tpu.ops import fused_codec as jfc

from multimodal_rssm_torch.cli import verify_fused_codec
from multimodal_rssm_torch.ops import cuda_kernels as ck
from multimodal_rssm_torch.ops import fused_codec as fc

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _inputs(case, seed=0):
    """numpy f32 (x, w, scale, bias, r) drawn as the JAX op's tests draw
    them; r is the cotangent of y."""
    n, h, wd, cin, kh, kw, cout, ph, pw = case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, wd, cin)).astype(np.float32)
    w = rng.normal(size=(kh, kw, cin, cout)).astype(np.float32) * 0.1
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    bias = (rng.normal(size=cout) * 0.1).astype(np.float32)
    ho, wo = h + 2 * ph - kh + 1, wd + 2 * pw - kw + 1
    r = rng.normal(size=(n, ho, wo, cout // 2)).astype(np.float32)
    return x, w, scale, bias, r


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(grad)


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=name, **tol)


def _jax_grads(fn, x, w, scale, bias, r):
    return jax.grad(lambda *a: jnp.sum(fn(*a)[0] * r), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, w, scale, bias)))


# -- (a) forward, (b) gradients through ConvInGlu.backward ------------------------


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax_op(case):
    x, w, scale, bias, _ = _inputs(case)
    pad = case[7:]
    want = jfc.conv_in_glu(*map(jnp.asarray, (x, w, scale, bias)), pad, 1e-5,
                           True)
    got = fc.conv_in_glu(*map(_t, (x, w, scale, bias)), pad)
    for g, wv, name in zip(got, want, ("y", "mean", "var")):
        _close(g, wv, FWD, name)
    assert not got[1].requires_grad and not got[2].requires_grad


@pytest.mark.parametrize("case", CASES[:2])
def test_gradients_match_jax_op(case):
    """dx, dw, dscale, dbias of sum(y * r) through the plain K3a -> K3b ->
    K3c chain of ``ConvInGlu.backward`` (no autograd through the plain
    forward) against jax.grad of the JAX op's custom VJP."""
    x, w, scale, bias, r = _inputs(case, seed=1)
    pad = case[7:]
    want = _jax_grads(lambda *a: jfc.conv_in_glu(*a, pad, 1e-5, True),
                      x, w, scale, bias, r)
    leaves = [_t(a, grad=True) for a in (x, w, scale, bias)]
    y, _, _ = fc.conv_in_glu(*leaves, pad)
    (y * _t(r)).sum().backward()
    for leaf, wv, name in zip(leaves, want, ("dx", "dw", "dscale", "dbias")):
        _close(leaf.grad, wv, GRAD, name)


# -- (c) each plain version against its JAX counterpart -------------------------


@pytest.mark.parametrize("kernel", ["fwd", "bwd_dz", "dgrad", "wgrad"])
def test_plain_versions_match_jax_kernels(kernel):
    """K2 against ``_fwd_impl``; K3a's dscale and dbias against
    ``_bwd_impl``'s and its dz against the JAX VJP of the InstanceNorm + GLU
    tail; K3b and K3c (fed the port's dz) against ``_bwd_impl``'s dx, dw."""
    case = CASES[0]
    x, w, scale, bias, r = _inputs(case, seed=2)
    pad, eps = case[7:], 1e-5
    jargs = tuple(map(jnp.asarray, (x, w, scale, bias)))
    jy, jz, jmean, jvar = jfc._fwd_impl(*jargs, pad, eps, True)
    if kernel == "fwd":
        got = fc.conv_in_glu_fwd_plain(*map(_t, (x, w, scale, bias)), pad,
                                       eps)
        for g, wv, name in zip(got, (jy, jz, jmean, jvar),
                               ("y", "z", "mean", "var")):
            _close(g, wv, FWD, name)
        return
    dz, dscale, dbias = fc.in_glu_bwd_dz_plain(
        _t(r), *map(_t, (jz, jmean, jvar, scale, bias)), eps)
    jdx, jdw, jdscale, jdbias = jfc._bwd_impl(
        (*jargs, jz, jmean, jvar), jnp.asarray(r), pad, eps, True)
    if kernel == "bwd_dz":
        def in_glu(z):
            mean = jnp.mean(z, axis=(1, 2), keepdims=True)
            var = jnp.maximum(jnp.mean(z * z, axis=(1, 2), keepdims=True)
                              - mean * mean, 0.0)
            a = jargs[2] * jax.lax.rsqrt(var + eps)
            zn = z * a + (jargs[3] - mean * a)
            c2 = z.shape[-1] // 2
            return zn[..., :c2] * jax.nn.sigmoid(zn[..., c2:])

        (jdz,) = jax.vjp(in_glu, jz)[1](jnp.asarray(r))
        _close(dz, jdz, GRAD, "dz")
        _close(dscale, jdscale, GRAD, "dscale")
        _close(dbias, jdbias, GRAD, "dbias")
    elif kernel == "dgrad":
        _close(fc.conv_dgrad_plain(dz, _t(w), pad), jdx, GRAD, "dx")
    else:
        _close(fc.conv_wgrad_plain(_t(x), dz, w.shape[:2], pad), jdw, GRAD,
               "dw")


# -- (d) conv_transpose_in_glu ----------------------------------------------------


def test_conv_transpose_matches_jax_op_and_torch_layer():
    """conv_transpose_in_glu against the JAX op and against
    nn.ConvTranspose2d + InstanceNorm + GLU (the up0 stage), values and
    gradients; w in the ConvTranspose layout [kh, kw, Cin, Cout]."""
    n, h, wd, cin, cout, kh, kw, ph, pw = 4, 8, 4, 8, 16, 3, 4, 1, 1
    x, w, scale, bias, _ = _inputs((n, h, wd, cin, kh, kw, cout, ph, pw), 3)
    y_shape = (n, h, wd + 1, cout // 2)
    r = np.random.default_rng(4).normal(size=y_shape).astype(np.float32)

    def jax_op(*a):
        return jfc.conv_transpose_in_glu(*a, (ph, pw), 1e-5, True)

    def torch_layer(x, w, scale, bias):
        ct = torch.nn.ConvTranspose2d(cin, cout, (kh, kw), padding=(ph, pw),
                                      bias=False)
        z = torch.func.functional_call(
            ct, {"weight": w.permute(2, 3, 0, 1)}, (x.permute(0, 3, 1, 2),))
        z = z.permute(0, 2, 3, 1)
        mean = z.mean(dim=(1, 2), keepdim=True)
        var = torch.clamp((z * z).mean(dim=(1, 2), keepdim=True) - mean ** 2,
                          min=0)
        a = scale * torch.rsqrt(var + 1e-5)
        zn = z * a + (bias - mean * a)
        return (zn[..., :cout // 2] * torch.sigmoid(zn[..., cout // 2:]),)

    want_y = jax_op(*map(jnp.asarray, (x, w, scale, bias)))[0]
    want_g = _jax_grads(jax_op, x, w, scale, bias, r)
    for fn in (lambda *a: fc.conv_transpose_in_glu(*a, (ph, pw)),
               torch_layer):
        leaves = [_t(a, grad=True) for a in (x, w, scale, bias)]
        y = fn(*leaves)[0]
        assert tuple(y.shape) == y_shape
        _close(y, want_y, FWD, "y")
        (y * _t(r)).sum().backward()
        for leaf, wv, name in zip(leaves, want_g, ("dx", "dw", "dscale",
                                                   "dbias")):
            _close(leaf.grad, wv, GRAD, name)


# -- (e) the unfused reference ----------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_reference_matches_jax_test_reference(case):
    x, w, scale, bias, _ = _inputs(case, seed=5)
    pad = case[7:]
    want = ref_conv_in_glu(*map(jnp.asarray, (x, w, scale, bias)), pad)
    got = fc.reference_conv_in_glu(*map(_t, (x, w, scale, bias)), pad)
    for g, wv, name in zip(got, want, ("y", "mean", "var")):
        _close(g, wv, FWD, name)


# -- (f) the verify CLI --------------------------------------------------------


def test_verify_cli_passes_on_cpu(capsys):
    out = verify_fused_codec.main(["--device", "cpu", "--n", "4",
                                   "--dtype", "float32"])
    assert set(out) == {"down4", "up0"}
    for stage, res in out.items():
        assert res["passed"], (stage, res["errors"])
        assert res["fused_grad_step_ms"] is None     # no timing off the card
        assert set(res["errors"]) == {"y", "mean", "var", "dx", "dw",
                                      "dscale", "dbias"}
    assert len(capsys.readouterr().out.strip().splitlines()) == 2


# -- (g) what the wrappers refuse --------------------------------------------------


def _small():
    x = torch.zeros(2, 8, 5, 8)
    w = torch.zeros(3, 3, 8, 16)
    s = torch.ones(16)
    return x, w, s


@pytest.mark.parametrize("bad", ["stride", "odd_cout", "dtype", "device",
                                 "non_contiguous", "positions", "dz_shape",
                                 "dz_positions"])
def test_wrappers_raise_on_what_they_do_not_take(bad):
    x, w, s = _small()
    ck.reset_launch_counts()
    err = TypeError if bad == "dtype" else ValueError
    with pytest.raises(err):
        if bad == "stride":
            fc.conv_in_glu_fwd(x, w, s, s, (1, 1), stride=2)
        elif bad == "odd_cout":
            fc.conv_in_glu_fwd(x, w[..., :15].contiguous(), s[:15], s[:15],
                               (1, 1))
        elif bad == "dtype":
            fc.conv_in_glu_fwd(x.double(), w.double(), s, s, (1, 1))
        elif bad == "device":
            fc.conv_in_glu_fwd(x, w, s.to("meta"), s, (1, 1))
        elif bad == "non_contiguous":
            fc.in_glu_bwd_dz(torch.zeros(2, 8, 8, 5).transpose(2, 3),
                             torch.zeros(2, 8, 5, 16), torch.zeros(2, 16),
                             torch.ones(2, 16), s, s)
        elif bad == "positions":
            fc.conv_in_glu_fwd(torch.zeros(1, 17, 16, 8), w, s, s, (1, 1))
        elif bad == "dz_positions":      # K3a holds <= MAX_POSITIONS, as K2
            fc.in_glu_bwd_dz(torch.zeros(1, 17, 16, 8),
                             torch.zeros(1, 17, 16, 16), torch.zeros(1, 16),
                             torch.ones(1, 16), s, s)
        else:
            fc.conv_wgrad(x, torch.zeros(2, 8, 4, 16), (3, 3), (1, 1))
    assert all(v == 0 for v in ck.launch_counts().values())


# -- (h) the build of every kernel source ------------------------------------------


def test_build_runs_one_compiler_per_stale_source(tmp_path, monkeypatch):
    """``build`` compiles each ``kernels/*.cu`` into its own library, again
    only when the source or any ``*.cuh`` is newer than it, or when forced
    (a stand-in compiler records its calls: there is no nvcc here)."""
    kdir, bdir = tmp_path / "kernels", tmp_path / "build"
    kdir.mkdir()
    for name in ("a", "b"):
        (kdir / f"{name}.cu").write_text("// kernel\n")
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        'while [ $# -gt 0 ]; do [ "$1" = -o ] && out="$2"; src="$1"; shift; '
        "done\n"
        f'echo "$src" >> {tmp_path}/calls\n'
        'echo "ptxas info    : Used 8 registers"\n'
        'touch "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(ck, "KERNEL_DIR", str(kdir))
    monkeypatch.setattr(ck, "BUILD_DIR", str(bdir))
    monkeypatch.setattr(ck, "_nvcc", lambda: str(fake))

    def calls():
        path = tmp_path / "calls"
        return sorted(os.path.basename(p) for p in
                      path.read_text().split()) if path.exists() else []

    def age(path, seconds):
        os.utime(path, (seconds, seconds))

    libs, seconds, log = ck.build()
    assert sorted(libs) == ["a", "b"] and calls() == ["a.cu", "b.cu"]
    assert all(os.path.exists(p) for p in libs.values())
    assert seconds > 0 and "Used 8 registers" in log
    for p in libs.values():
        age(p, 2_000_000_000)
    assert ck.build() == (libs, 0.0, "")           # up to date
    age(kdir / "a.cu", 2_000_000_100)
    ck.build()
    assert calls() == ["a.cu", "a.cu", "b.cu"]     # only the newer source
    age(libs["a"], 2_000_000_200)
    (kdir / "common.cuh").write_text("// shared\n")
    age(kdir / "common.cuh", 2_000_000_300)
    ck.build()
    assert calls() == ["a.cu", "a.cu", "a.cu", "b.cu", "b.cu"]
    ck.build(force=True)
    assert len(calls()) == 7


# -- (i) the host logic of the wgmma K3b / K3c ---------------------------------------


@pytest.mark.parametrize("rows,tiles,sms", [
    (313_600, 48, 132),      # down4 at N = 2450 on an H100
    (392_000, 48, 132),      # up0
    (384, 6, 132), (480, 48, 132), (280, 3, 132),
    (10_000_000, 1, 132),    # capped at MAX_SPLITS
    (2_113, 1, 132),         # 34 stages: the cap cuts the split count
    (64, 5, 132), (1, 1, 132), (4_001, 7, 16)])
def test_wgmma_wgrad_split_plan_covers_every_row_once(rows, tiles, sms):
    """For the wgmma K3c's plan (64-row stages, one block per SM) and the
    WMMA one's (32-row stages, two blocks per SM), split z covers rows
    [z per, (z + 1) per): together the splits cover every reduction row
    exactly once, each in whole stages, none empty, at most MAX_SPLITS of
    them, and enough for two waves of blocks where the cap and the rows
    allow."""
    for stage, per_sm in ((fc.WG_STAGE, 1), (fc._BK, 2)):
        blocks = per_sm * sms
        splits, per = fc.wgrad_splits(rows, tiles, stage, blocks)
        assert per % stage == 0 and 1 <= splits <= fc.MAX_SPLITS
        covered = np.zeros(rows, np.int64)
        for z in range(splits):
            lo, hi = z * per, min((z + 1) * per, rows)
            assert hi > lo
            covered[lo:hi] += 1
        assert (covered == 1).all()
        stages = -(-rows // stage)
        most = -(-stages // -(-stages // fc.MAX_SPLITS))   # most <= the cap
        assert splits >= min(-(-2 * blocks // tiles), most)


@pytest.mark.parametrize("dtype,cin,cout,wgmma", [
    (torch.bfloat16, 256, 512, True),     # the codec's stages
    (torch.bfloat16, 64, 128, True),
    (torch.bfloat16, 64, 64, True),
    (torch.float32, 256, 512, False),     # f32 keeps the WMMA kernels
    (torch.bfloat16, 24, 160, False),
    (torch.bfloat16, 3, 10, False),
    (torch.bfloat16, 256, 96, False)])
def test_wgmma_variant_choice_by_dtype_and_shape(dtype, cin, cout, wgmma):
    """bf16 with both channel counts multiples of 64 and a kernel at most
    32 taps high takes the wgmma kernels; everything else the WMMA ones."""
    assert fc.uses_wgmma(dtype, cin, cout, 3) is wgmma
    assert not fc.uses_wgmma(dtype, cin, cout, 33)


@pytest.mark.parametrize("dtype,cin,cout,wgmma", [
    (torch.bfloat16, 256, 512, True),     # the codec's stages
    (torch.bfloat16, 64, 128, True),      # C/2 = 64: one column tile
    (torch.bfloat16, 64, 640, True),      # C/2 = 320: a masked pair tile
    (torch.float32, 256, 512, False),     # f32 keeps the WMMA kernel
    (torch.bfloat16, 256, 496, False),    # C/2 = 248
    (torch.bfloat16, 256, 64, False),     # C/2 = 32
    (torch.bfloat16, 24, 512, False)])    # Cin = 24
def test_forward_variant_choice_by_dtype_and_shape(dtype, cin, cout, wgmma):
    """K2 takes its wgmma kernel for bf16 with Cin and C/2 multiples of 64,
    whatever the kernel size; everything else the WMMA one."""
    assert fc.fwd_uses_wgmma(dtype, cin, cout) is wgmma


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_refuses_more_positions_than_a_block_holds(dtype):
    """Ho * Wo over MAX_POSITIONS raises before either K2 kernel is chosen,
    also at the channel counts that take the wgmma one in bf16."""
    x = torch.zeros(1, 17, 16, 64, dtype=dtype)
    w = torch.zeros(3, 3, 64, 128, dtype=dtype)
    s = torch.ones(128)
    assert (17 * 16 > fc.MAX_POSITIONS
            and fc.fwd_uses_wgmma(dtype, 64, 128) is (dtype == torch.bfloat16))
    ck.reset_launch_counts()
    with pytest.raises(ValueError, match="positions"):
        fc.conv_in_glu_fwd(x, w, s, s, (1, 1))
    assert all(v == 0 for v in ck.launch_counts().values())
