"""The easyaug augmentations of theseus_tpu_torch against the JAX package, on the CPU, in float64.

The port splits every augmentation into draws from a torch.Generator and a
pure function of the draws. These tests replay the JAX package's key chain
(the splits and draws of theseus_tpu/utils/examples/easyaug.py, written out
here) and feed its draws to the port: each of the nine photometric ops,
the whole RandomPhotoAug pipeline on (B, H, W) and (B, C, H, W) images,
RandomGeoAug's transforms and warps, `random_homography`, `geo_aug` and
`photo_aug`. Values agree to 1e-12 (warped images to 1e-10: a homography
that differs by rounding samples a slightly different point). The draws
from a torch.Generator are held to their ranges and to reproducibility.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theseus_tpu.utils.examples import easyaug as J
from theseus_tpu_torch.utils.examples import easyaug as T

TOL = dict(rtol=1e-12, atol=1e-12)
WARP_TOL = dict(rtol=1e-10, atol=1e-10)
H, W = 20, 26


def _imgs(shape, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape)


def _t(a):
    return torch.as_tensor(np.array(a))


def _op_draws(op, ko, shape):
    """The draws JAX's RandomPhotoAug.<op>(ko, img, mag) makes, by name."""
    uni = lambda k, lo=0.0, hi=1.0, s=(): jax.random.uniform(k, s, minval=lo, maxval=hi)  # noqa: E731
    if op in ("contrast", "exposure", "gamma"):
        return {"u": uni(ko, -1.0, 1.0)}
    if op in ("sharpen", "gaussian_smooth"):
        return {"u": uni(ko)}
    k1, k2 = jax.random.split(ko)
    if op == "motion_blur":
        return {"theta": uni(k1, 0.0, jnp.pi), "u": uni(k2)}
    if op == "shadow_highlight":
        return {"u_lo": uni(k1), "u_hi": uni(k2)}
    if op == "gaussian_noise":
        return {"n": jax.random.normal(ko, shape, jnp.float64)}
    assert op == "salt_and_pepper"
    return {"u": uni(k1, s=shape), "salt": uni(k2, s=shape)}


def _stack(dicts):
    return {k: _t(np.stack([np.asarray(d[k]) for d in dicts])) for k in dicts[0]}


def _pipeline_draws(key, b, shape):
    """RandomPhotoAug.forward's key chain: a key per batch element, then per
    op (key, gate key, op key) = split(key, 3)."""
    per_b = []
    for kb in jax.random.split(key, b):
        d = {}
        for op in J._PHOTO_OPS:
            kb, kp, ko = jax.random.split(kb, 3)
            d[op] = {"gate": jax.random.uniform(kp, ()), **_op_draws(op, ko, shape)}
        per_b.append(d)
    return {op: _stack([d[op] for d in per_b]) for op in J._PHOTO_OPS}


@pytest.mark.parametrize("op", T.PHOTO_OPS)
@pytest.mark.parametrize("mag", [0.3, 1.0])
def test_photometric_op_matches_jax(op, mag):
    b = 3
    imgs = _imgs((b, H, W), seed=1)
    keys = jax.random.split(jax.random.PRNGKey(7), b)
    want = np.stack([np.asarray(getattr(J.RandomPhotoAug, op)(k, jnp.asarray(im), mag))
                     for k, im in zip(keys, imgs)])
    draws = _stack([_op_draws(op, k, (H, W)) for k in keys])
    got = T._OPS[op](_t(imgs), mag, **draws)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(want - imgs).max() > 1e-6  # the op did something


@pytest.mark.parametrize("channels", [None, 2])
@pytest.mark.parametrize("prob", [0.5, 1.0])
def test_photo_pipeline_replays_jax_key_chain(channels, prob):
    b = 4
    shape = (b, H, W) if channels is None else (b, channels, H, W)
    imgs = _imgs(shape, seed=2)
    key = jax.random.PRNGKey(3)
    jaug, taug = J.RandomPhotoAug(), T.RandomPhotoAug()
    for a in (jaug, taug):
        a.set_all_probs(prob)
        a.set_all_mags(0.6)
    want = np.asarray(jaug.forward(key, jnp.asarray(imgs)))
    got = taug.forward(_t(imgs), draws=_pipeline_draws(key, b, (H, W)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_photo_pipeline_probability_zero_and_generator_draws():
    imgs = _t(_imgs((3, 2, H, W), seed=4))
    aug = T.RandomPhotoAug()
    aug.set_all_probs(0.0)
    assert torch.equal(aug.forward(imgs, torch.Generator().manual_seed(0)), imgs)
    aug.set_all_probs(1.0)
    a = aug.forward(imgs, torch.Generator().manual_seed(5))
    b = aug.forward(imgs, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.shape == imgs.shape
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0 and float((a - imgs).abs().max()) > 1e-3
    d = T.RandomPhotoAug.draw(5, H, W, torch.Generator().manual_seed(1), torch.float64)
    assert d["motion_blur"]["theta"].max() < math.pi and d["contrast"]["u"].min() >= -1.0
    assert d["gaussian_noise"]["n"].shape == (5, H, W)


def _geo_draws(geo, key, b, dtype=jnp.float64):
    """RandomGeoAug.forward's key chain: a key per batch element, split in 5."""
    per_b = []
    for k in jax.random.split(key, b):
        ks = jax.random.split(k, 5)
        m = geo.perspective_param
        per_b.append({
            "scale": geo.scale_param.sample(ks[0]).astype(dtype),
            "rotate": geo.rotate_param.sample(ks[1]).astype(dtype),
            "translate_x": geo.translate_x_param.sample(ks[2]),
            "translate_y": geo.translate_y_param.sample(ks[3]),
            "perspective": jax.random.uniform(ks[4], (4, 2), dtype=dtype, minval=m.min, maxval=m.max),
        })
    return _stack(per_b)


def _geo_pair(**ranges):
    jp = {k: J.GeoAugParam(*v) for k, v in ranges.items()}
    tp = {k: T.GeoAugParam(*v) for k, v in ranges.items()}
    return J.RandomGeoAug(**jp), T.RandomGeoAug(**tp)


@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("ranges", [
    {},
    {"scale_param": (0.97, 1.03), "rotate_param": (-0.08, 0.08), "translate_x_param": (-0.03, 0.03),
     "translate_y_param": (-0.03, 0.03), "perspective_param": (-0.02, 0.02)},
])
def test_geo_aug_transforms_and_warps_match_jax(channels, ranges):
    b = 3
    shape = (b, H, W) if channels is None else (b, channels, H, W)
    imgs = _imgs(shape, seed=5)
    key = jax.random.PRNGKey(11)
    jgeo, tgeo = _geo_pair(**ranges)
    want_img, want_mat = jgeo.forward(key, jnp.asarray(imgs), return_transform=True)
    got_img, got_mat = tgeo.forward(_t(imgs), return_transform=True, draws=_geo_draws(jgeo, key, b))
    np.testing.assert_allclose(got_mat.numpy(), np.asarray(want_mat), **TOL)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), **WARP_TOL)


def test_geo_aug_identity_and_generator():
    imgs = _t(_imgs((2, H, W), seed=6))
    geo = T.RandomGeoAug()
    out, mats = geo.forward(imgs, torch.Generator().manual_seed(0), return_transform=True)
    assert out.shape == imgs.shape and mats.shape == (2, 3, 3) and torch.all(mats[:, 2, 2] == 1)
    geo.set_all_identity()
    np.testing.assert_allclose(geo.forward(imgs, torch.Generator().manual_seed(0)).numpy(), imgs.numpy(),
                               atol=1e-12)
    d = T.RandomGeoAug().draw(6, torch.Generator().manual_seed(2), torch.float64)
    assert d["perspective"].shape == (6, 4, 2) and float(d["scale"].min()) >= 0.9


def test_random_homography_geo_aug_photo_aug_match_jax():
    key = jax.random.PRNGKey(2)
    img = np.asarray(jax.random.uniform(key, (H, W), dtype=jnp.float64))
    jitter = jax.random.uniform(key, (4, 2), dtype=jnp.float64, minval=-1, maxval=1)
    np.testing.assert_allclose(T.random_homography(H, W, 0.07, jitter=_t(jitter)).numpy(),
                               np.asarray(J.random_homography(key, H, W, 0.07, dtype=jnp.float64)), **TOL)
    ident = T.random_homography(H, W, 0.0, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    np.testing.assert_allclose(ident.numpy(), [1, 0, 0, 0, 1, 0, 0, 0], atol=1e-12)

    want_w, want_h8 = J.geo_aug(key, jnp.asarray(img), perturb=0.05)
    got_w, got_h8 = T.geo_aug(_t(img), perturb=0.05, jitter=_t(jitter))
    np.testing.assert_allclose(got_h8.numpy(), np.asarray(want_h8), **TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **WARP_TOL)

    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = {"brightness": jax.random.uniform(k1, (), minval=-1, maxval=1),
             "contrast": jax.random.uniform(k2, (), minval=-1, maxval=1),
             "gamma": jax.random.uniform(k3, (), minval=-1, maxval=1),
             "noise": jax.random.normal(k4, img.shape, dtype=jnp.float64)}
    got = T.photo_aug(_t(img), draws={k: _t(v) for k, v in draws.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(J.photo_aug(key, jnp.asarray(img))), **TOL)
    out = T.photo_aug(_t(img), generator=torch.Generator().manual_seed(0))
    assert out.shape == img.shape and float(out.min()) >= 0 and float(out.max()) <= 1


def test_homography_from_corners_round_trip():
    src = _t(np.array([[0.0, 0.0], [W - 1.0, 0.0], [0.0, H - 1.0], [W - 1.0, H - 1.0]]))
    dst = src + _t(np.random.default_rng(0).uniform(-2, 2, (4, 2)))
    h8 = T.homography_from_corners(src, dst)
    from theseus_tpu_torch.utils.warp import homography_transform

    np.testing.assert_allclose(homography_transform(h8, src).numpy(), dst.numpy(), atol=1e-10)
    np.testing.assert_allclose(h8.numpy(), np.asarray(J.homography_from_corners(jnp.asarray(src.numpy()),
                                                                                jnp.asarray(dst.numpy()))),
                               **TOL)
