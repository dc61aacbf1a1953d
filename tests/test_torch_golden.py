"""The port re-encodes the in-repo -9 golden byte for byte on the CPU."""

import bz2
import os

import pytest

import compressjs_tpu_torch as cz
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden')


@pytest.mark.parametrize('mode', ['full', 'hybrid'])
def test_golden_sample5_level9(mode):
    """Re-encoding the decoded golden gives the golden's bytes."""
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        gold = f.read()
    got = cz.compress_file_device(bz2.decompress(gold), level=9, mode=mode,
                                  device='cpu')
    assert len(got) == 273937
    assert got == gold
