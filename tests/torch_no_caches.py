"""A module fixture for the port's tests that damage drives by hand and
then read: the fileinfo and hot-object caches are switched off
(MTPU_FILEINFO_CACHE=off, MTPU_HOT_CACHE=off, the JAX package's kill
switches, read by both packages) for the whole module, so that a read
after the damage goes to the drives and exercises what it was written
for (reconstruct, heal, MRF) instead of a cache hit. Import it into the
module: `from tests.torch_no_caches import no_read_caches  # noqa: F401`.
"""

import pytest


@pytest.fixture(autouse=True, scope="module")
def no_read_caches():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MTPU_FILEINFO_CACHE", "off")
        mp.setenv("MTPU_HOT_CACHE", "off")
        yield
