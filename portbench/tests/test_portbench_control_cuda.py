"""On the card, at the cells' own sizes: the control (the reference in the
program's place at the next precision down) fails the cell's limit, and
the program passes it. The readings the limits were set from come from
`python3 -m portbench.limits`; this keeps the control as a test."""

import pytest

from portbench import run, spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    run.pin_caches()


@pytest.mark.cuda
@pytest.mark.parametrize("cell,controls", [
    ("prefill.context-8c", ("fp8", "int4")),
    ("query.agent-16c", ("below",))])
def test_control_fails_the_limit(card, cell, controls):
    bench = spec.load_benchmark()
    result = run.execute(bench, cell, 7_000_000_001, 51.0, False,
                         controls=controls)
    assert result["correct"], result["checks"]
    for control in controls:
        got = result["readings"][control]
        assert any(got[n] > c["limit"] for n, c in
                   result["checks"].items()), (control, got)
