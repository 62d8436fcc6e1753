"""The port's ``eval/fid.py`` against the JAX package's on the CPU, float32.

The Inception parameters are JAX's layout carried across (``inception_params``
in the helpers: random, with BN scales and biases away from the identity);
JAX's ``inception_pool3`` runs under one ``jax.jit`` per worker. pool3
features agree within 1e-4 of the largest feature at 32, 256 and 512 px
input (two grow to 299, one shrinks), and each trap of the layer stack has
its own case: the resize (antialiased only when it shrinks), ``"SAME"`` on
the 1x7 / 7x1 convs, the average pool with and without the padding in its
count, and FIDInceptionE_2's max pool. ``frechet_distance`` agrees to 1e-6
relative and calls ``sqrtm`` without ``disp``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamllm_tpu.eval.fid as jfid
import dreamllm_tpu_torch.eval.fid as pfid
from tests._torch_port_helpers import inception_params, jax_pool3, to_port

FEAT_REL = 1e-4
FD_REL = 1e-6


def _images(size, n=2, seed=0):
    return np.random.default_rng(seed).random((n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("size", [32, 256, 512, 299])
def test_pool3_matches_jax(size):
    jp, pp = inception_params()
    x = _images(size, seed=size)
    want = jax_pool3(jp, x)
    got = pfid.inception_pool3(pp, torch.from_numpy(x))
    assert got.shape == (2, 2048) and got.dtype == torch.float32
    scale = np.abs(want).max()
    assert scale > 0.1
    assert np.abs(got.numpy() - want).max() <= FEAT_REL * scale


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("size", [32, 256, 512])
def test_resize_matches_jax_bilinear(size):
    """``jax.image.resize(..., "bilinear")`` antialiases when it shrinks: 32
    and 256 grow to 299 (no antialias), 512 shrinks (antialias on)."""
    x = _images(size, n=1, seed=1)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3), method="bilinear"))
    got = _nhwc(pfid.resize_299(_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if size > 299:  # the trap: a plain bilinear shrink is another image
        plain = _nhwc(torch.nn.functional.interpolate(_nchw(x), size=(299, 299),
                                                      mode="bilinear", align_corners=False))
        assert np.abs(plain - want).max() > 1e-2


@pytest.mark.parametrize("kh,kw", [(1, 7), (7, 1), (3, 3), (1, 3), (3, 1), (5, 5)])
def test_same_padding_of_asymmetric_kernels(kh, kw):
    rng = np.random.default_rng(kh * 10 + kw)
    p = {"conv": {"w": (rng.standard_normal((kh, kw, 6, 5)) * 0.3).astype(np.float32),
                  "b": np.zeros(5, np.float32)},
         "bn_scale": (1 + 0.1 * rng.standard_normal(5)).astype(np.float32),
         "bn_bias": (0.1 * rng.standard_normal(5)).astype(np.float32)}
    x = rng.standard_normal((2, 9, 11, 6)).astype(np.float32)
    want = np.asarray(jfid._apply_bn_conv(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    pp = to_port(p, pfid._bn_conv(kh, kw, 6, 5, torch.float32, torch.device("meta"), None))
    got = _nhwc(pfid._apply_bn_conv(pp, _nchw(x)))
    assert got.shape == want.shape == (2, 9, 11, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("count_include_pad", [True, False])
def test_avg_pool_matches_jax(count_include_pad):
    x = np.random.default_rng(3).standard_normal((2, 7, 6, 4)).astype(np.float32) + 1.0
    want = np.asarray(jfid._avg_pool(jnp.asarray(x), count_include_pad=count_include_pad))
    got = _nhwc(pfid._avg_pool(_nchw(x), count_include_pad=count_include_pad))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if not count_include_pad:  # the corner divides by 4, not 9
        np.testing.assert_allclose(got[:, 0, 0], x[:, :2, :2].mean(axis=(1, 2)), rtol=1e-6)


@pytest.mark.parametrize("kind", ["stride2-valid", "stride1-same"])
def test_max_pool_matches_jax(kind):
    """Stride 2 VALID (the reductions) and FIDInceptionE_2's stride-1 SAME
    max pool, which pads with -inf."""
    x = np.random.default_rng(4).standard_normal((2, 9, 8, 3)).astype(np.float32) - 5.0
    if kind == "stride2-valid":
        want = jfid._max_pool(jnp.asarray(x))
        got = pfid._max_pool(_nchw(x))
    else:
        want = jfid._max_pool(jnp.asarray(x), window=3, stride=1, pad="SAME")
        got = pfid._max_pool(_nchw(x), stride=1, padding=1)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


def test_init_shapes_match_jax_and_generator_seeds():
    jp, _ = inception_params()
    a = pfid.init_inception_params(generator=torch.Generator().manual_seed(5), device="cpu")
    b = pfid.init_inception_params(generator=torch.Generator().manual_seed(5), device="cpu")
    to_port(jp, a)  # JAX's tree fits the port's: same structure and shapes
    assert torch.equal(a["mixed_7c"]["b3d_3b"]["conv"]["w"], b["mixed_7c"]["b3d_3b"]["conv"]["w"])
    assert a["mixed_6b"]["b7_2"]["conv"]["w"].shape == (128, 128, 1, 7)


def _stats(seed, n=40, d=6):
    rng = np.random.default_rng(seed)
    return pfid.activation_statistics(rng.standard_normal((n, d)) @ rng.standard_normal((d, d)))


def test_frechet_distance_matches_jax_without_disp(monkeypatch):
    import scipy.linalg

    calls = []
    sqrtm = scipy.linalg.sqrtm

    def spy(a, *args, **kw):
        calls.append(kw)
        return sqrtm(a, *args, **kw)

    (m1, s1), (m2, s2) = _stats(0), _stats(1)
    want = jfid.frechet_distance(m1, s1, m2, s2)
    monkeypatch.setattr(scipy.linalg, "sqrtm", spy)
    got = pfid.frechet_distance(m1, s1, m2, s2)
    assert calls and all("disp" not in kw for kw in calls)
    assert got == pytest.approx(want, rel=FD_REL) and got > 0
    # the analytic case of the JAX tests: isotropic, means 3 apart in 4 dims
    assert pfid.frechet_distance(np.zeros(4), np.eye(4), np.full(4, 3.0), np.eye(4)) == \
        pytest.approx(36.0, rel=1e-6)


def test_frechet_distance_singular_covariance_matches_jax():
    """Fewer samples than dimensions: singular covariances, where ``sqrtm``
    may need the eps-on-diagonal retry; both packages give the same
    number."""
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((3, 8)), rng.standard_normal((3, 8)) + 0.5
    (m1, s1), (m2, s2) = pfid.activation_statistics(a), pfid.activation_statistics(b)
    want = jfid.frechet_distance(m1, s1, m2, s2)
    assert pfid.frechet_distance(m1, s1, m2, s2) == pytest.approx(want, rel=FD_REL)


def test_fid_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((50, 5)), rng.standard_normal((60, 5)) * 1.3
    assert pfid.compute_fid(a, b) == pytest.approx(jfid.compute_fid(a, b), rel=FD_REL)
    assert pfid.compute_fid(a, a.copy()) == pytest.approx(0.0, abs=1e-8)
    pfid.save_stats_npz(b, str(tmp_path / "ref.npz"))
    d = np.load(tmp_path / "ref.npz")
    mu, sigma = jfid.activation_statistics(b)
    assert np.array_equal(d["mu"], mu) and np.array_equal(d["sigma"], sigma)
    assert pfid.compute_fid_against_stats(a, str(tmp_path / "ref.npz")) == pytest.approx(
        jfid.compute_fid_against_stats(a, str(tmp_path / "ref.npz")), rel=FD_REL)


def test_stats_from_image_dir_matches_jax(tmp_path):
    """PNGs of a directory -> pool3 statistics, the ragged tail padded to
    the batch (3 images, batch 2)."""
    from PIL import Image

    rng = np.random.default_rng(6)
    for i in range(3):  # three brightness levels: features that differ
        img = rng.integers(0, 85, (40, 40, 3)) + 85 * i
        Image.fromarray(img.astype(np.uint8)).save(tmp_path / f"{i}.png")
    jp, pp = inception_params()
    jfid_out = str(tmp_path / "jax.npz")
    pfid_out = str(tmp_path / "port.npz")
    jfid.stats_from_image_dir(jp, str(tmp_path), jfid_out, batch_size=2, image_size=32)
    pfid.stats_from_image_dir(pp, str(tmp_path), pfid_out, batch_size=2, image_size=32)
    j, p = np.load(jfid_out), np.load(pfid_out)
    scale = np.abs(j["mu"]).max()
    assert np.abs(p["mu"] - j["mu"]).max() <= FEAT_REL * scale
    # a random Inception's features vary across images by about 1e-3 of
    # their size, so the features' float32 differences (1e-7 of the size)
    # are about 1e-4 of the spread; sigma, a product of two spreads, within
    # 1e-3 of its largest entry
    assert np.abs(p["sigma"] - j["sigma"]).max() <= 1e-3 * np.abs(j["sigma"]).max()
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no images"):
        pfid.stats_from_image_dir(pp, str(tmp_path / "empty"), pfid_out)


def test_full_float32_restores_the_flags():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with pfid.full_float32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
