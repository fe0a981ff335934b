"""The port's mini capacity atlas against the JAX reference's, on the CPU.

Each package runs tests/test_atlas.py's mini atlas (its MINI_KW, at an
eps_b of this module's own) on two of its four topologies, a grid and a
cycle, on its own noise: the horizon is
long enough for the verdicts to mean something, so the two land within
one grid step per cell, and the port's atlas table equals the reference's
on the port's rows.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import fleet as jfleet  # noqa: E402
from repro_torch import fleet as tfleet  # noqa: E402
from test_torch_atlas import MINI_EPS, MINI_FAMILIES, _as_reference  # noqa: E402

MINI_KW = dict(seeds=(0,), T=2048, chunk=256, rel_tol=0.2, max_calls=8)


def _cells(pkg):
    return [pkg.AtlasJob(f, policy="pi3", eps_b=MINI_EPS)
            for f in MINI_FAMILIES]


@pytest.fixture(scope="module")
def mini():
    return tfleet.sweep_lambda_max(_cells(tfleet),
                                   device="cpu", **MINI_KW)


@pytest.fixture(scope="module")
def jax_mini():
    return jfleet.sweep_lambda_max(_cells(jfleet), **MINI_KW)


def test_mini_atlas_within_one_grid_step_of_the_reference(mini, jax_mini):
    """The port's mini atlas, on its own noise, against the JAX mini atlas
    on JAX's: the same bounds and grid, λ_max within one grid step per
    cell (verdicts near a threshold hang on the noise, ROADMAP C2)."""
    assert mini.n_step_compiles == mini.n_programs == 1
    assert mini.n_rewrites >= mini.n_cells
    assert mini.n_launches < mini.seq_launches
    by_cell = {r.scenario: r for r in jax_mini.rows}
    for row in mini.rows:
        ref = by_cell[row.scenario]
        step = MINI_KW["rel_tol"] * row.bound_exact
        assert row.bound_exact == ref.bound_exact
        assert abs(row.lam_max - ref.lam_max) <= step * (1 + 1e-9), (
            row.scenario, row.lam_max, ref.lam_max)
        assert 0.0 <= row.ratio <= 1.0 + 1e-9


def test_atlas_table_equals_the_reference_on_the_mini_rows(mini):
    assert tfleet.atlas_table(mini) == \
        jfleet.atlas_table(_as_reference(mini, jfleet))
