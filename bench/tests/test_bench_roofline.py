"""The byte count of one ``fold_flat`` call against the shapes of the
kernel phase of the port's chip smoke test (39,002,652 lanes over 8M
rows: 0.170 ms at 3.35 TB/s)."""
from __future__ import annotations

import pytest

from bench import roofline


def test_fold_flat_bound_at_the_smoke_test_shape():
    nbytes = roofline.fold_flat_bytes(39_002_652, 8_000_000)
    assert nbytes == 13 * 39_002_652 + 8 * 8_000_000
    assert roofline.bound_s(nbytes) * 1e3 == pytest.approx(0.170, abs=5e-4)


def test_power_limit_without_a_card_is_none_or_a_number():
    w = roofline.power_limit_w()
    assert w is None or w > 0
