"""bf16 AMP training parity at a routed flash length: the Transformer of
``torch_amp_setup.py`` (2+2 layers, d 128) at seq 576, where every
attention op takes flash (#2-#4), against the JAX package's bf16 run
(its Pallas kernels in interpret mode). 576 rather than 520: the Pallas
flash kernel picks its block from the largest power of two that divides
T, 8 at 520, whose 65 x 65 grid of blocks a head makes interpret mode
too slow here. Tolerances: those of ``test_torch_amp.py``.
"""
import pytest
import torch

from torch_amp_setup import check_amp_training


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_transformer_amp_matches_reference_at_seq_576(tmp_path):
    check_amp_training(576, tmp_path)
