"""The port's CUDA kernels against their plain versions, on the card.

Imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest

Without a card every test skips.
"""

import pytest
import torch

from image_diffusion_torch.ops.attention import packed_attention, reference_packed_attention

# the UNet sites, and ragged Q tiles (N=48 < 64, N=80 not a multiple of 64)
SITES = [(1024, 256, 8), (1024, 128, 8), (256, 384, 8), (256, 256, 8),
         (64, 512, 8), (64, 384, 8), (16, 512, 8), (48, 128, 4), (80, 64, 4)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,heads", SITES)
def test_cuda_kernel_matches_plain_version(card, N, C, heads):
    """bf16 outputs: |kernel - plain| <= 2e-2 + 2e-2 |plain|."""
    g = torch.Generator(device="cuda").manual_seed(N + C)
    q, k, v = (torch.randn(4, N, C, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    before = packed_attention.launches
    got = packed_attention(q, k, v, heads)
    torch.cuda.synchronize()
    assert packed_attention.launches == before + 1
    ref = reference_packed_attention(q, k, v, heads)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError):
        packed_attention(q.float(), k.float(), v.float(), heads)
    with pytest.raises(ValueError):
        packed_attention(q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1), heads)


@pytest.mark.cuda
def test_unet_forward_launches_the_kernel_at_every_site(card):
    from image_diffusion_torch.core.config import UNetArch
    from image_diffusion_torch.models import build_unet

    arch = UNetArch(channels=(64, 128, 128), mid_channels=(128, 128), time_dim=64,
                    num_res_layers=1, num_heads=4, num_groups=8)
    g = torch.Generator().manual_seed(0)
    state = build_unet(arch, torch.float32, "cpu", g).state_dict()
    gpu, cpu = build_unet(arch, device="cuda"), build_unet(arch, device="cpu")
    gpu.load_state_dict(state)
    cpu.load_state_dict(state)
    x, t, c = torch.randn(2, 32, 32, 3, generator=g), torch.tensor([3, 700]), torch.tensor([0, 2])
    before = packed_attention.launches
    with torch.inference_mode():
        out = gpu(x.cuda(), t.cuda(), c.cuda()).float().cpu()
        ref = cpu(x, t, c).float()
    assert packed_attention.launches - before == 5  # 2 down + 1 mid + 2 up sites
    assert float((out - ref).norm() / ref.norm()) < 5e-2
