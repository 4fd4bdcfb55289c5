"""The control comes out as not correct through the harness's own check,
in each cell, on three seeds: the reference with one active message of
each lane lost, in the program's place, with the reference simulator's
records.  That the program's own lanes pass the same check is the harness
tests' part."""
import pytest

from nexusbench import control, harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 1, 77])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, seed):
    r = control.readings(cell, seed, 200)
    assert not r["correct"]
    assert r["compared"]["wrong"]["value"] > r["compared"]["wrong"]["limit"]
    assert r["compared"]["bad_record"]["value"] == 0
