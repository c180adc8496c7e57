"""Shared fixtures.  NOTE: XLA_FLAGS/device-count tricks are deliberately
NOT set here — smoke tests and benches must see 1 real CPU device; the
multi-pod dry-run sets its own flags in its own process (launch/dryrun.py).
"""
import pytest

from repro.configs import get_arch
from repro.core import build_profile


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the port's CUDA kernels); "
        "skips with a reason elsewhere")


@pytest.fixture(scope="session")
def gpt27_profile():
    return build_profile(get_arch("gpt3_2_7b"), microbatch=2, seq_len=2048)


@pytest.fixture(scope="session")
def small_profile():
    """A small uniform profile: 10 layers, cheap to plan."""
    return build_profile(get_arch("gpt2"), microbatch=1, seq_len=512)
