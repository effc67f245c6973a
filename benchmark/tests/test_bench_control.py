"""The control on the card at each cell's own size, on three seeds: the
fp32 reference computed a precision below the configuration's (fp8
operands, `reference/lowp.py`) in the program's place fails one of the
cell's compared numbers, and so does each planted fault a training cell
can have (the half batch; a state left unchanged reads 1 by the change's
measure), while the program passes.  Runs only on the card:

    python -m pytest benchmark/tests/test_bench_control.py -m cuda
"""

import json

import pytest
import torch

import harness

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [4100000001, 4100000002, 4100000003])
def test_the_control_fails_the_check(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size, on the card")
    cell = harness.Cell(name)
    session = cell.driver.Session(cell.config, cell.traffic, seed, "cuda")
    train = cell.traffic["kind"] != "sample"
    for _ in range(session.min_units):
        session.run_unit()
    readings = session.check(control=True, **({"fault": "half_batch"} if train else {}))
    limits = cell.limits
    assert all(readings[k] <= v for k, v in limits.items()), readings
    assert any(readings[f"control.{k}"] > v for k, v in limits.items()), readings
    if train:
        assert any(readings[f"fault.{k}"] > v for k, v in limits.items()), readings
