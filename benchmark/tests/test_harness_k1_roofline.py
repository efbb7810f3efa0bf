"""K1's frozen bound from the shapes alone: 0.591 ms at k=1 and 1.312 ms
at k=2 on the 1024^2 mesh of an H100, both set by the bytes."""

import importlib.util

import pytest

from conftest import REPO

spec = importlib.util.spec_from_file_location(
    "k1_roofline", REPO / "benchmark" / "metrics" / "k1_roofline.py")
k1 = importlib.util.module_from_spec(spec)
spec.loader.exec_module(k1)


@pytest.mark.parametrize("cd,fd,ms", [(2, 1, 0.591), (3, 2, 1.312)])
def test_bound_at_1024(cd, fd, ms):
    bound, by = k1.bound_ms(1024 * 1024, cd, fd,
                            "NVIDIA H100 80GB HBM3")
    assert by == "bytes"
    assert bound == pytest.approx(ms, abs=5e-4)


def test_float32_halves_the_bytes():
    b64, _ = k1.bound_ms(1024 * 1024, 2, 1, "H100")
    b32, _ = k1.bound_ms(1024 * 1024, 2, 1, "H100", value_bytes=4)
    assert b32 == pytest.approx(b64 / 2)
    assert k1.local_size(2, 1) == 14 and k1.local_size(3, 2) == 22
