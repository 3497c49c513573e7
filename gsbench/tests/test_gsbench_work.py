"""The frozen least-work counts start equal to the port's own formulas."""
import pytest

from gsbench.work import gsproject_cost, least_ms, param_floats, step_work


@pytest.mark.parametrize("n", [4_000_768, 18_180_096 // 4, 18_180_096])
@pytest.mark.parametrize("coeffs", [1, 4, 9, 16])
def test_gsproject_formula_equals_the_ports(n, coeffs):
    from repro_torch.kernels import cost

    assert gsproject_cost(n, coeffs) == cost.gsproject_cost(n, coeffs)


def test_step_work_at_the_one_card_cell():
    ops, nbytes = step_work(4_000_768, 4, 4 * 512 * 512, 0)
    p = param_floats(0)
    assert p == 14
    assert nbytes == 7 * p * 4 * 4_000_768 + 4 * 4 * (p + 11) * 4_000_768 + 4 * 4 * (2 * p + 11) * 4_000_768 \
        + 4 * 4 * 512 * 512 * 3 * 4
    assert least_ms(ops, nbytes) == pytest.approx(nbytes / 3.35e12 * 1e3)
