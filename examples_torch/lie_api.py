"""Tour of the functional Lie layer and the LieArray wrapper (the port of examples/lie_api.py).

Functional ops, analytic jacobians, the typed array API, and composition
with torch.func (vmap, jacrev). Draws come from a CPU torch.Generator
seeded 0. Runs on the card unless --device cpu is given.

    python examples_torch/lie_api.py [--device cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch

from examples_torch import _config
from theseus_tpu_torch import config, lie
from theseus_tpu_torch.lie import LieArray


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None, help="cuda or cpu (default: the card)")
    args = _config.parse_with_config(p, argv)
    dev = config.resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    kw = dict(generator=gen, dtype=torch.float32, device=dev)

    # --- functional namespace (like torchlie.functional) -----------------
    g = lie.SE3.rand(4, **kw)  # (4, 3, 4)
    w = lie.SE3.log(g)  # (4, 6) tangent
    print("log shape:", tuple(w.shape))
    (jac,), back = lie.SE3.jexp(w)  # analytic jacobian + value
    print("jexp jac:", tuple(jac.shape), "consistency:", float((back - g).abs().max()))

    # ops compose with vmap/jacrev
    jac_auto = torch.func.vmap(torch.func.jacrev(lambda x: lie.SE3.log(lie.SE3.exp(x))))(w)
    print("vmap(jacrev(log o exp)) == I:",
          bool(torch.allclose(jac_auto, torch.eye(6, device=dev).expand_as(jac_auto), atol=1e-5)))

    # --- typed wrapper (like torchlie.LieTensor) --------------------------
    a = LieArray.rand(lie.SO3, 8, **kw)
    b = LieArray.rand(lie.SO3, 8, **kw)
    c = a @ b  # compose (closed op)
    print("between:", tuple(a.between(b).shape), "log:", tuple(c.log().shape))
    try:
        a + b
    except TypeError as e:
        print("addition blocked:", str(e)[:60], "...")

    delta = 0.1 * torch.randn((8, 3), generator=gen).to(dev)
    print("retract/local roundtrip:", float((a.retract(delta).local(a) + delta).abs().max()))

    # a function of LieArrays, traced once by torch.func.vmap over the batch
    def normalize_chain(x: LieArray):
        return x.inv().compose(x.compose(x)).log()

    print("LieArray through a function:", tuple(normalize_chain(a).shape))


if __name__ == "__main__":
    main()
