import pytest

from tokenbench.tests.smoke import write_bench


@pytest.fixture
def smoke(tmp_path):
    return tmp_path, write_bench(tmp_path)
