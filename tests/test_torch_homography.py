"""The homography tasks of theseus_tpu_torch against the JAX package's examples, on the CPU, in float64.

- `smooth_images` against examples/homography_learned.py's on the same
  noise draws (F.interpolate's bilinear upsampling against
  jax.image.resize's: equal to rounding, 1e-12);
- the CNN on the JAX example's weights (utils/convert.py
  `homography_cnn_params`) against its `cnn_features` (1e-12);
- the learned task: the loss and its CNN gradients, and the parameters
  after two Adam steps, against the JAX example's `make_loss` with optax's
  adam on the same pairs, at batch 2, patch stride 8 and 3 LM iterations,
  in both autograd modes (1e-7);
- the dense photometric fit of examples/homography_estimation.py at 60x80,
  10 LM iterations (1e-8), and its float64 estimate against h_true;
- `make_pairs` from a torch.Generator: shapes, ranges, reproducibility.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.utils.warp import bilinear_sample as jsample, homography_transform as jtransform, image_grid as jgrid
from theseus_tpu_torch.utils.convert import homography_cnn_params
from theseus_tpu_torch.utils.examples import homography as th

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
import homography_estimation as he  # noqa: E402
import homography_learned as hl  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-12)
TRAIN_TOL = dict(rtol=1e-7, atol=1e-7)
FIT_TOL = dict(rtol=1e-8, atol=1e-8)
H_TRUE = np.array([1.02, 0.01, 1.5, -0.02, 0.98, -1.0, 1e-4, -5e-5])


def _t(a):
    return torch.as_tensor(np.array(a))


def test_smooth_images_match_jax():
    key = jax.random.PRNGKey(4)
    b, h, w = 3, hl.H, hl.W
    want = hl.smooth_images(key, b, h, w)
    noise = []
    for hs, ws in th.smooth_noise_shapes(h, w):
        k1, key = jax.random.split(key)
        noise.append(_t(jax.random.uniform(k1, (b, hs, ws))))
    got = th.smooth_images(b, h, w, noise=noise, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    g = th.smooth_images(2, 20, 30, generator=torch.Generator().manual_seed(0), dtype=torch.float64, device="cpu")
    assert g.shape == (2, 20, 30) and float(g.max()) == 1.0 and float(g.min()) > 0


@pytest.mark.parametrize("channels", [4, 2])
def test_cnn_matches_jax_features(channels):
    params = hl.init_cnn(jax.random.PRNGKey(1), channels)
    imgs = np.random.default_rng(0).uniform(size=(2, 12, 16))
    cnn = th.CNN(channels, dtype=torch.float64, device="cpu")
    cnn.load_state_dict(homography_cnn_params(params, torch.float64, "cpu"))
    got = th.channels_last(cnn(_t(imgs)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(hl.cnn_features(params, jnp.asarray(imgs))), **TOL)


def test_corner_error_matches_jax():
    rng = np.random.default_rng(1)
    a = np.tile(H_TRUE, (3, 1)) + 0.01 * rng.standard_normal((3, 8))
    b = np.tile(H_TRUE, (3, 1))
    np.testing.assert_allclose(float(th.corner_error(_t(a), _t(b), hl.H, hl.W)),
                               float(hl.corner_error(jnp.asarray(a), jnp.asarray(b))), **TOL)


@pytest.mark.parametrize("mode", ["fwd", "rev"])
def test_learned_loss_gradients_and_two_adam_steps_match_jax(mode):
    import optax

    b, iters, lr = 2, 3, 2e-3
    hl.set_patch_stride(8)
    try:
        layer, obj = hl.build_layer(mode, max_iterations=iters)
        loss_fn = jax.jit(jax.value_and_grad(hl.make_loss(layer, obj, b)))
        params = hl.init_cnn(jax.random.PRNGKey(1))
        tx = optax.adam(lr)
        opt_state = tx.init(params)
        tr = th.HomographyTrainer(hl.H, hl.W, hl.CHANNELS, 8, mode, iters, lr=lr, dtype=torch.float64, device="cpu")
        assert tr.patch.shape == (hl.NP_PATCH, 2)
        tr.cnn.load_state_dict(homography_cnn_params(params, torch.float64, "cpu"))
        key = jax.random.PRNGKey(0)
        for _ in range(2):
            key, k = jax.random.split(key)
            img1, img2, h8_true = hl.make_pairs(k, b)
            want, g = loss_fn(params, img1, img2, h8_true)
            assert want.dtype == jnp.float64
            updates, opt_state = tx.update(g, opt_state)
            got = tr.step(_t(img1), _t(img2), _t(h8_true))
            np.testing.assert_allclose(float(got), float(want), **TRAIN_TOL)
            grads = homography_cnn_params(g, torch.float64, "cpu")
            for name, p in tr.cnn.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), **TRAIN_TOL, err_msg=name)
            params = optax.apply_updates(params, updates)
        for name, p in homography_cnn_params(params, torch.float64, "cpu").items():
            np.testing.assert_allclose(tr.cnn.state_dict()[name].numpy(), p.numpy(), **TRAIN_TOL, err_msg=name)
    finally:
        hl.set_patch_stride(4)


def _jax_fit(img1, img2, iters):
    """examples/homography_estimation.py's solve, at `iters` LM iterations."""
    h, w = img1.shape
    patch = jgrid(h - 16, w - 16) + 8.0
    target = jsample(img2, patch)
    h8 = jt.Vector(8, name="h8")

    def err_fn(optim, aux):
        (hv,) = optim
        img, tgt = aux
        return jsample(img, jtransform(hv, patch)) - tgt

    obj = jt.Objective()
    obj.add(jt.AutoDiffCostFunction([h8], patch.shape[0], err_fn,
                                    aux_vars=[jt.Variable(img1[None], name="img1"),
                                              jt.Variable(target[None], name="target")], name="photo"))
    layer = jt.TheseusLayer(jt.LevenbergMarquardt(obj, max_iterations=iters, adaptive_damping=True))
    values, info = layer.forward({"h8": jnp.asarray([[1.0, 0, 0, 0, 1.0, 0, 0, 0]])})
    return np.asarray(values["h8"]), np.asarray(info.last_err)


def test_photometric_fit_matches_jax():
    h, w, iters = 60, 80, 10
    img1 = he.smooth_image(jax.random.PRNGKey(0), h, w)
    img2 = jsample(img1, jtransform(jnp.asarray(H_TRUE), jgrid(h, w))).reshape(h, w)
    want_h8, want_err = _jax_fit(img1, img2, iters)
    est, info = th.fit_photometric(_t(img1)[None], _t(img2)[None], max_iterations=iters)
    np.testing.assert_allclose(est.numpy(), want_h8, **FIT_TOL)
    np.testing.assert_allclose(info.last_err.numpy(), want_err, **FIT_TOL)
    assert np.abs(est.numpy()[0] - H_TRUE).max() < 0.2  # the JAX example's assertion


def test_photometric_fit_batched_equals_per_element():
    """A batch of two pairs solves as the two pairs alone (LM's damping is
    per element; the stopping tests are off, so that rounding near a
    tolerance cannot stop one run an iteration before the other)."""
    h, w = 30, 40
    imgs = th.smooth_images(2, h, w, generator=torch.Generator().manual_seed(2), dtype=torch.float64, device="cpu")
    h8s = torch.as_tensor(np.stack([H_TRUE, H_TRUE + [0.0, 0.0, -1.0, 0.0, 0.0, 0.5, 0.0, 0.0]]))
    warped = torch.stack([th.bilinear_sample(imgs[i], th.homography_transform(h8s[i], th.image_grid(
        h, w, dtype=torch.float64))).reshape(h, w) for i in range(2)])
    kw = dict(max_iterations=8, optimizer_kwargs={"abs_err_tolerance": 0.0, "rel_err_tolerance": 0.0})
    both, _ = th.fit_photometric(imgs, warped, **kw)
    for i in range(2):
        one, _ = th.fit_photometric(imgs[i:i + 1], warped[i:i + 1], **kw)
        np.testing.assert_allclose(both[i].numpy(), one[0].numpy(), rtol=1e-10, atol=1e-10)


def test_make_pairs_from_generator():
    img1, img2, h8 = th.make_pairs(3, 24, 32, generator=torch.Generator().manual_seed(0), dtype=torch.float64,
                                   device="cpu")
    assert img1.shape == img2.shape == (3, 24, 32) and h8.shape == (3, 8)
    assert float(img1.min()) >= 0 and float(img2.max()) <= 1
    # small warps: scale 3 %, rotation 0.08 rad, shifts and corner jitter of 3 % and 2 %
    assert float(th.corner_error(h8, th.identity_h8(3, torch.float64, "cpu"), 24, 32)) < 4.0
    again = th.make_pairs(3, 24, 32, generator=torch.Generator().manual_seed(0), dtype=torch.float64, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip((img1, img2, h8), again))


def test_cli_reads_the_jax_config_and_trains(capsys):
    """scripts/torch_homography.py with examples/configs/homography_learned.yaml
    (the JAX example's config), small overrides on the command line."""
    import importlib.util

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("torch_homography", root / "scripts" / "torch_homography.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    rc = cli.main(["--config", str(root / "examples" / "configs" / "homography_learned.yaml"), "--steps", "2",
                   "--batch", "2", "--patch-stride", "16", "--device", "cpu", "--ablate"])
    out = capsys.readouterr().out
    assert rc == 0 and "fwd: corner err" in out and "rev: corner err" in out
    with pytest.raises(SystemExit):
        cli.parse_with_config(__import__("argparse").ArgumentParser(), ["--config", str(
            root / "examples" / "configs" / "homography_estimation.yaml")])


def test_draws_come_from_the_generator_wherever_they_go():
    """A CPU generator gives the same CNN weights and pairs whatever device
    they are made for (drawn on the generator's device, then moved)."""
    a = th.CNN(4, torch.Generator().manual_seed(3), dtype=torch.float64, device="cpu")
    b = th.CNN(4, torch.Generator().manual_seed(3), dtype=torch.float64, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    from theseus_tpu_torch.utils.examples.easyaug import draw_random

    g = torch.Generator().manual_seed(0)
    want = torch.randn((3, 4), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    assert torch.equal(draw_random(True, (3, 4), g, torch.float64, None), want)
