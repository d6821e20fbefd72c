"""utils/warp.py of theseus_tpu_torch against the JAX package, on the CPU, in float64.

Values of `bilinear_sample` (with and without channels, border clamping),
`homography_transform` and `image_grid`; the derivative at a border tie,
where jnp.clip gives 1/2 (the port clamps with torch.maximum/minimum,
which split the same way; torch.clamp would give 1); first derivatives by
autograd, jacfwd and jacrev; the Hessian (a double backward) through the
homography and the sampler; and the sampler inside an
`AutoDiffCostFunction`, mapped by vmap over instances and batch and
differentiated by jacfwd and jacrev, against the JAX package's
linearization. Everything agrees to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import theseus_tpu as jt
from theseus_tpu.utils import warp as J
import theseus_tpu_torch as tt
from theseus_tpu_torch.utils import warp as T

TOL = dict(rtol=1e-12, atol=1e-12)
RNG = np.random.default_rng(0)
IMG = RNG.standard_normal((7, 9, 3))
XY = np.concatenate([
    np.stack([RNG.uniform(-1, 10, 30), RNG.uniform(-1, 8, 30)], -1),
    # ties: the grid's own corners and points on the border lines
    [[0.0, 0.0], [8.0, 6.0], [8.0, 0.0], [0.0, 6.0], [8.0, 2.5], [3.5, 0.0], [4.0, 3.0]],
])
H8 = np.array([1.02, 0.01, 1.5, -0.02, 0.98, -1.0, 1e-4, -5e-5])


@pytest.mark.parametrize("chan", [True, False])
def test_bilinear_sample_values_match_jax(chan):
    img = IMG if chan else IMG[..., 0]
    got = T.bilinear_sample(torch.as_tensor(img), torch.as_tensor(XY))
    np.testing.assert_allclose(got.numpy(), np.asarray(J.bilinear_sample(jnp.asarray(img), jnp.asarray(XY))), **TOL)
    # far outside clamps to the border pixel
    far = torch.tensor([[-5.0, -5.0], [100.0, 100.0]], dtype=torch.float64)
    np.testing.assert_allclose(T.bilinear_sample(torch.as_tensor(img), far).numpy(), img[[0, -1], [0, -1]])


def test_homography_transform_and_grid_match_jax():
    grid = T.image_grid(5, 6, dtype=torch.float64)
    assert grid.shape == (30, 2) and grid[1].tolist() == [1.0, 0.0] and grid[6].tolist() == [0.0, 1.0]
    np.testing.assert_allclose(grid.numpy(), np.asarray(J.image_grid(5, 6, dtype=jnp.float64)))
    got = T.homography_transform(torch.as_tensor(H8), grid)
    np.testing.assert_allclose(got.numpy(), np.asarray(J.homography_transform(jnp.asarray(H8), jnp.asarray(grid))),
                               **TOL)
    # broadcast: h8 (B, 1, 8) against points (1, N, 2)
    hb = np.stack([H8, H8 * 1.01, H8 * 0.99])[:, None]
    got = T.homography_transform(torch.as_tensor(hb), grid[None])
    want = J.homography_transform(jnp.asarray(hb), jnp.asarray(grid)[None])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _sum_sample(pkg, img):
    mod = T if pkg == "torch" else J
    return lambda xy: (mod.bilinear_sample(img, xy) ** 2).sum()


@pytest.mark.parametrize("mode", ["grad", "jacfwd", "jacrev"])
def test_bilinear_gradients_match_jax_with_border_ties(mode):
    img = IMG[..., 1]
    want = np.asarray(jax.grad(_sum_sample("jax", jnp.asarray(img)))(jnp.asarray(XY)))
    f = _sum_sample("torch", torch.as_tensor(img))
    xy = torch.as_tensor(XY)
    if mode == "grad":
        x = xy.clone().requires_grad_()
        (got,) = torch.autograd.grad(f(x), x)
    else:
        got = getattr(torch.func, mode)(f)(xy)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_border_tie_derivative_is_half():
    """At x = 0 and x = w - 1 exactly, d sample / dx carries jnp.clip's 1/2."""
    img = torch.as_tensor(np.arange(12.0).reshape(3, 4))  # f = 4 y + x: d/dx = 1 inside
    xy = torch.tensor([[0.0, 1.0], [3.0, 1.0], [1.5, 1.0]], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(T.bilinear_sample(img, xy).sum(), xy)
    np.testing.assert_allclose(g[:, 0].numpy(), [0.5, 0.5, 1.0])
    want = jax.grad(lambda z: J.bilinear_sample(jnp.asarray(img.numpy()), z).sum())(jnp.asarray(xy.detach().numpy()))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), **TOL)
    jf = torch.func.jacfwd(lambda z: T.bilinear_sample(img, z).sum())(xy.detach())
    np.testing.assert_allclose(jf.numpy(), np.asarray(want), **TOL)


def test_double_backward_through_homography_matches_jax():
    img = IMG[..., 2]
    grid = T.image_grid(4, 5, dtype=torch.float64) + 2.0
    h8 = np.array([1, 0, 0.3, 0, 1, 0.2, 0, 0], dtype=np.float64)

    def loss(pkg):
        mod = T if pkg == "torch" else J
        im = torch.as_tensor(img) if pkg == "torch" else jnp.asarray(img)
        gr = grid if pkg == "torch" else jnp.asarray(grid.numpy())
        return lambda h: (mod.bilinear_sample(im, mod.homography_transform(h, gr)) ** 2).sum()

    want = np.asarray(jax.hessian(loss("jax"))(jnp.asarray(h8)))
    got = torch.autograd.functional.hessian(loss("torch"), torch.as_tensor(h8))
    assert got.shape == (8, 8) and float(got.abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # and by an explicit double backward
    h = torch.as_tensor(h8).requires_grad_()
    (g,) = torch.autograd.grad(loss("torch")(h), h, create_graph=True)
    (row,) = torch.autograd.grad(g[2], h)
    np.testing.assert_allclose(row.numpy(), want[2], **TOL)


def _feature_objective(pkg, mode, b=2, k=2):
    """k feature-metric costs over one homography each, per batch element:
    the learned-homography residual at a small size."""
    is_t = pkg is tt
    mod = T if is_t else J
    arr = (lambda a: np.asarray(a)) if is_t else jnp.asarray
    patch = mod.image_grid(3, 4, dtype=torch.float64 if is_t else jnp.float64) + 2.0
    obj = tt.Objective(dtype=torch.float64, device="cpu") if is_t else jt.Objective(dtype=jnp.float64)
    rng = np.random.default_rng(1)

    def err_fn(optim, aux):
        (h,) = optim
        feat, tgt = aux
        return (mod.bilinear_sample(feat, mod.homography_transform(h, patch)) - tgt).reshape(-1)

    for i in range(k):
        h8 = pkg.Vector(8, name=f"h{i}")
        f1 = pkg.Variable(arr(rng.standard_normal((b, 8, 9, 2))), name=f"f1_{i}")
        f2 = pkg.Variable(arr(rng.standard_normal((b, 12, 2))), name=f"f2_{i}")
        obj.add(pkg.AutoDiffCostFunction([h8], 24, err_fn, aux_vars=[f1, f2], name=f"c{i}",
                                         autograd_mode=mode))
    init = np.tile(H8, (b, 1)) + 0.01 * rng.standard_normal((b, 8))
    return obj, {f"h{i}": arr(init) for i in range(k)}


@pytest.mark.parametrize("mode", ["fwd", "rev"])
def test_sampler_inside_autodiff_cost_matches_jax(mode):
    obj, vals = _feature_objective(tt, mode)
    jobj, jvals = _feature_objective(jt, mode)
    co, jco = obj.compile(), jobj.compile()
    values, jvalues = obj.default_values(vals), jobj.default_values(jvals)
    state, aux = co.pack(values, 2), co.build_aux(values, 2)
    jstate, jaux = jco.pack(jvalues, 2), jco.build_aux(jvalues, 2)
    assert len(co.buckets) == 1 and co.buckets[0].k == 2  # one err_fn: the costs share a bucket
    np.testing.assert_allclose(co.error(state, aux).numpy(), np.asarray(jco.error(jstate, jaux)), **TOL)
    for (jacs, err), (wj, we) in zip(co.linearize_blocks(state, aux), jco.linearize_blocks(jstate, jaux)):
        np.testing.assert_allclose(err.numpy(), np.asarray(we), **TOL)
        for a, w in zip(jacs, wj):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
