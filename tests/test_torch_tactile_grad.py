"""The tactile trainer's gradients of theseus_tpu_torch against the JAX package, on the CPU, in float64.

The trainer's loss and its gradient with respect to every parameter of
both MLPs in the unroll, implicit, truncated and dlm modes (T = 5, batch 2,
features of dim 6, the episode and parameters of tests/test_torch_tactile.py)
against `jax.value_and_grad` of the JAX trainer's loss (jitted: eager
evaluation compiles every primitive of the solve on its own): the loss
1e-8, each parameter's gradient 1e-7 relative to its largest entry.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_tactile import _flat_grads, _torch_params, _trainer_pair


@pytest.mark.parametrize("mode", ["unroll", "implicit", "truncated", "dlm"])
def test_trainer_loss_and_gradients_match_jax(mode):
    jtr, tr, jin, tin = _trainer_pair(mode)
    want, jg = jax.jit(jax.value_and_grad(jtr.loss))(jtr.params, *jin)
    loss = tr.loss(*tin)
    params = _torch_params(tr)
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-8)
    for g, w in zip(grads, _flat_grads(jg)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-7 * max(float(np.abs(w).max()), 1e-12))
    assert max(float(g.abs().max()) for g in grads) > 0
