"""The port's dry-run of the prefill and decode cells of every family but
the dense one, at the smoke configs on a fake 2×2 mesh, on the CPU (the
train cells are in ``test_torch_dryrun_families.py``)."""
import pytest

from test_torch_dryrun_families import OTHER_FAMILIES, ok_or_listed, \
    smoke_cell


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", OTHER_FAMILIES)
def test_family_serving_cells(tmp_path, name, kind):
    ok_or_listed(smoke_cell(tmp_path, name, kind))
