"""chip_smoke.py's phase dist rehearsed on the CPU at small size on 4 gloo
ranks: each kind of DIST_CASES through the same function (dist_case),
its kernels' plain versions counted as the card counts its launches, the
counts held exactly, on every rank, to dist_launches_needed, the formula
the card run checks (from the solve's its and each rank's bound operator,
PC and exchange tables)."""

import pytest

import chip_smoke
from dist_parity import shared_pool

# DIST_CASES at small size (the card's sizes and the reference's results
# are in chip_smoke.DIST_CASES and tests/data/dist_contract.json)
SMALL = {
    "main_f64": (16, ("-pc_gamg_structured_limit", "100")),
    "main_f32": (16, ("-pc_gamg_structured_limit", "100")),
    "jacobi_128": (8, ()),
    "gamg_dist_64": (16, ("-pc_gamg_dist_coarse_limit", "100")),
    "bjacobi_64": (8, ()),
    "fieldsplit_16": (8, ()),
}


@pytest.fixture(scope="module")
def pool():
    return shared_pool(chip_smoke.DIST_RANKS)


@pytest.mark.parametrize("name", list(chip_smoke.DIST_CASES))
def test_phase_dist_launches_match_the_formula(pool, name):
    n, extra = SMALL[name]
    opts = tuple(chip_smoke.DIST_CASES[name][2]) + extra
    outs = pool.run("dist_phase_rehearsal", name, n, opts)
    for got, need, rec in outs:
        assert rec["reason"].startswith("CONVERGED"), rec
        assert got == need, (name, got, need)
        assert rec["true_relres"] <= 1e-7
    assert len({o[2]["its"] for o in outs}) == 1
    if name.startswith("main"):
        assert [k for k, _ in outs[0][2]["levels"][:3]] == ["dnd_mpi"] * 3
    if name.startswith("gamg_dist"):
        assert [k for k, _ in outs[0][2]["levels"][:2]] == ["mpiaij"] * 2
