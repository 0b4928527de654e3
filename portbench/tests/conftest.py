import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda_only: needs an NVIDIA Hopper card (vuke_tpu_torch kernels)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is there (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
