"""float32 against float64 per family, at the CPU shape and step count
where each gate of ``validation.dtype_gates`` was measured: the error must
stay within ``FACTOR`` of the stated value, and must not vanish (a zero
error means both runs computed in the same dtype)."""
import pytest

from multiphase_lbm_tpu.validation import dtype_gates as dg


@pytest.mark.parametrize("family", sorted(dg.GATES))
def test_f32_against_f64_within_gate(family):
    shape, steps, measured = dg.GATES[family]
    err = dg.f32_f64_error(family, shape, steps)
    assert 0.0 < err <= dg.tolerance(family), (family, err, measured)
