"""DiT-XL/2's attention on the card: the packed forward kernel at d = 72
against its plain version, the DiT's launches, and the DiT and the KL-f8
decoder in bf16 on the card against the benchmark's fp32 reference.

Imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest tests/test_torch_port_dit_cuda.py -q -m cuda --noconftest

Without a card every test skips.
"""

import pytest
import torch

from image_diffusion_torch.core.config import DiTArch, VAEArch
from image_diffusion_torch.models import build_denoiser, build_vae
from image_diffusion_torch.ops import group_norm, reference_group_norm
from image_diffusion_torch.ops.attention import (
    packed_attention,
    packed_attention_with_row_sum,
    reference_packed_attention,
)

import dit_reference

# (B, N, C, heads): DiT-XL/2's site at the cell's 128 rows (wgmma route),
# the CPU tests' small size (N = 16) and ragged Q tiles (mma.sync route)
D72_SITES = [(128, 256, 1152, 16), (4, 16, 144, 2), (4, 80, 144, 2), (4, 192, 288, 4)]
SMALL_DIT = dict(input_size=8, patch_size=2, hidden_size=144, depth=2, num_heads=2,
                 num_classes=10)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,C,heads", D72_SITES)
def test_d72_kernel_matches_plain_version(card, B, N, C, heads):
    """bf16 outputs: |kernel - plain| <= 2e-2 + 2e-2 |plain|, the bar of the
    other head dims (test_torch_port_cuda.py); row sums 1e-3 relative."""
    g = torch.Generator(device="cuda").manual_seed(N + C)
    q, k, v = (torch.randn(B, N, C, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    before = packed_attention.launches
    with torch.no_grad():
        got = packed_attention(q, k, v, heads)
    out, row_sum = packed_attention_with_row_sum(q, k, v, heads)
    torch.cuda.synchronize()
    assert packed_attention.launches == before + 2
    ref, ref_sum = reference_packed_attention(q, k, v, heads, return_row_sum=True)
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(row_sum, ref_sum, atol=0, rtol=1e-3)
    assert torch.equal(out, got)


@pytest.mark.cuda
def test_d72_sites_route_plain_with_grad(card):
    """The backward kernels have no d = 72: with grad enabled the DiT's
    attention takes the einsum path and launches nothing."""
    model = build_denoiser(DiTArch(**SMALL_DIT), device="cuda",
                           generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 8, 4, device="cuda")
    t, y = torch.tensor([3, 900], device="cuda"), torch.tensor([1, 2], device="cuda")
    before = packed_attention.launches
    model(x, t, y).float().sum().backward()
    assert packed_attention.launches == before
    with torch.no_grad():
        model(x, t, y)
    assert packed_attention.launches == before + SMALL_DIT["depth"]


@pytest.mark.cuda
def test_dit_xl2_launches_the_kernel_at_its_28_sites(card):
    arch = DiTArch()
    model = build_denoiser(arch, device="cuda", generator=torch.Generator().manual_seed(0))
    assert len(model.blocks) == 28 and model.y_embedder.embedding_table.num_embeddings == 1001
    x = torch.randn(4, 32, 32, 4, device="cuda")
    before = packed_attention.launches
    with torch.no_grad():
        out = model(x, torch.tensor([999, 500, 20, 0], device="cuda"),
                    torch.tensor([0, 999, 5, 7], device="cuda"), torch.ones(4, 1, device="cuda"))
    torch.cuda.synchronize()
    assert packed_attention.launches - before == 28
    assert out.shape == (4, 32, 32, 8) and torch.isfinite(out.float()).all()


@pytest.mark.cuda
def test_dit_and_decoder_in_bf16_on_the_card_hold_to_the_reference(card):
    """The small DiT (its two d = 72 sites through the kernel) and a
    3-level ldm decoder in bf16 on the card against the fp32 reference on
    the same weights, at the CPU tests' bf16 bars (test_torch_port_dit.py:
    2e-2 and 6e-2)."""
    ref, nets = dit_reference.load("dit"), dit_reference.load("nets")

    arch = dict(DiTArch(**SMALL_DIT).to_dict())
    P = ref.dit_weights(arch, 7, "cuda", torch.bfloat16)
    model = build_denoiser(DiTArch(**SMALL_DIT), device="cuda")
    model.load_state_dict(P)
    x = torch.randn(6, 8, 8, 4, device="cuda")
    t = torch.tensor([999, 900, 500, 100, 10, 0], device="cuda")
    y = torch.tensor([0, 3, 9, 10, 1, 10], device="cuda")
    Pf = {k: v.float() for k, v in P.items()}
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    with torch.no_grad():
        got = model(x, t, y)
        want = ref.dit(Pf, arch, x, t, y)
    assert rel(got, want) < 2e-2
    va = VAEArch(channels=(32, 64, 64), z_dim=4, init_resolution=32, num_groups=8, layout="ldm",
                 latent_scale=0.18215)
    vd = {**va.to_dict(), "channels": [32, 64, 64]}
    Pv = nets.make_weights(ref.ldm_decoder_leaves(vd), 8, "cuda", torch.bfloat16)
    vae = build_vae(va, device="cuda")
    vae.load_state_dict(Pv)
    z = torch.randn(3, 8, 8, 4, device="cuda")
    with torch.no_grad():
        got = vae.decode(z)
        want = ref.ldm_decode({k: v.float() for k, v in Pv.items()}, vd, z)
    assert rel(got, want) < 6e-2


@pytest.mark.cuda
@pytest.mark.parametrize("C,HW,silu", [(512, 1024, True), (128, 65536, True), (512, 1024, False)])
def test_group_norm_kernel_takes_the_decoders_eps(card, C, HW, silu):
    """The KL-f8 decoder's eps 1e-6 reaches the kernel: it matches the fp32
    formula at 1e-6, and a tensor of tiny variance tells 1e-6 from 1e-5."""
    g = torch.Generator(device="cuda").manual_seed(C)
    x = (1e-3 * torch.randn(2, C, 1, HW, generator=g, device="cuda")).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.rand(C, generator=g, device="cuda") + 0.5
    b = torch.randn(C, generator=g, device="cuda")
    with torch.no_grad():
        got = group_norm(x, w, b, 32, silu, 1e-6)
        default = group_norm(x, w, b, 32, silu)
    want = reference_group_norm(x.float(), w, b, 32, silu, 1e-6)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
    assert rel(default, want) > 5 * rel(got, want)
