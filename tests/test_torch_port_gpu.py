"""PyTorch port, on the card: each hand-written kernel against its plain
version.  Imports nothing of JAX, so that it runs where only the port's
dependencies are installed:

    python -m pytest --noconftest tests/test_torch_port_gpu.py -q

(``--noconftest``: the suite's conftest sets up JAX).  Without a GPU each
test skips with its reason.
"""

import pytest
import torch

from multimodal_rssm_torch.ops import cuda_kernels as ck


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU build")
    return torch.device("cuda")


@pytest.mark.gpu
def test_normalize_kernel_matches_plain_on_card(cuda):
    """The kernel equals its plain version exactly, for f32, uint8 and a
    misaligned ragged view (the scalar path), and counts each launch."""
    g = torch.Generator(cuda).manual_seed(0)
    x8 = torch.randint(0, 256, (4, 5, 64, 64, 3), generator=g, device=cuda,
                       dtype=torch.uint8)
    seed = torch.tensor(99, device=cuda)
    before = ck.normalize_image.launches
    for x in (x8.float(), x8, x8.float().reshape(-1)[1:10_003]):
        assert torch.equal(ck.normalize_image(x, 5, seed),
                           ck.normalize_image_plain(x, 5, seed))
    assert ck.normalize_image.launches == before + 3


@pytest.mark.gpu
def test_normalize_kernel_rejects_what_it_does_not_take(cuda):
    """A seed on another device or a float64 image raises before launch."""
    x = torch.zeros(64, device=cuda)
    before = ck.normalize_image.launches
    with pytest.raises(ValueError):
        ck.normalize_image(x, 5, torch.tensor(1))
    with pytest.raises(TypeError):
        ck.normalize_image(x.double(), 5, torch.tensor(1, device=cuda))
    assert ck.normalize_image.launches == before
