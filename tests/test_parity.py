"""Backend parity: the archives of the pinned seeded inputs must hash to
the digests in spring_tpu/utils/parity.py (chip_smoke.py checks the same
digests on the GPU)."""
import pytest

from spring_tpu.utils import parity


@pytest.mark.parametrize("case", sorted(parity.CASES))
def test_pinned_archive_digest(tmp_path, case):
    seen = parity.run_case(case, str(tmp_path))
    assert parity.mismatches(case, seen) == []
