"""The plain reference agrees with the program in float64 on the CPU, at
tiny sizes of each cell."""

import torch

from _tiny import tiny_problem


def test_pgo_solve_matches_the_program():
    p = tiny_problem("pgo_sphere2500.solve_b64")
    out, _ = p.solve(0)
    assert p.judge_solve([(0, p.answer(out))])["cost_gap"] < 1e-12


def test_pgo_implicit_training_matches_the_program():
    from _tiny import SEED, SPEC, TINY
    from portbench import run

    cfg, traffic = TINY["pgo_sphere2500.train_b64"]
    p = run.Cell(SPEC, "pgo_sphere2500.train_b64", dict(cfg, dtype="float64"), traffic).problem(SEED, "cpu")
    history, first = run.first_steps(p, 3)
    gaps = p.judge_train(history, first)
    assert gaps["loss_gap"] < 1e-7 and gaps["grad_gap"] < 1e-8 and gaps["change_gap"] < 1e-6, gaps
    assert abs(gaps["cost_gap"]) < 1e-12, gaps


def test_bfloat16_storage_is_rounded_and_far_from_float64():
    p = tiny_problem("pgo_sphere2500.solve_b64")
    x = p.reference_solve(0, "bfloat16")
    assert x.dtype == torch.float32 and torch.equal(x, x.to(torch.bfloat16).float())
    assert p.judge_solve([(0, x)])["cost_gap"] > 100 * p.judge_solve([(0, p.reference_solve(0, "float32"))])["cost_gap"]


def test_reference_jacobians_match_finite_differences():
    from portbench.reference import lie

    g = torch.Generator().manual_seed(3)
    x = lie.exp(0.5 * torch.randn((4, 6), generator=g, dtype=torch.float64))
    m = lie.exp(0.5 * torch.randn((4, 6), generator=g, dtype=torch.float64))
    f = lambda d: lie.local(m, lie.compose(x, lie.exp(d)))  # noqa: E731
    z = torch.zeros((4, 6), dtype=torch.float64)
    for k in range(6):
        e = torch.zeros_like(z)
        e[:, k] = 1.0
        _, jvp = torch.func.jvp(lambda d: lie.local(m, lie.perturb(x, d)), (z,), (e,))
        fd = (f(1e-6 * e) - f(-1e-6 * e)) / 2e-6
        assert torch.allclose(jvp, fd, atol=1e-8)
