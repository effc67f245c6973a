"""The port's CUDA kernels against their plain versions, on the card, and
the UNet's and the VAE's attention gradients through them against the CPU.

Imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest

Without a card every test skips.
"""

import pytest
import torch

from image_diffusion_torch.ops.attention import (
    packed_attention,
    packed_attention_bwd,
    reference_packed_attention,
    reference_packed_attention_bwd,
)

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


@pytest.mark.cuda
@pytest.mark.parametrize("N,C,heads", SITES)
def test_cuda_bwd_kernel_matches_plain_version(card, N, C, heads):
    """dq, dk, dv (bf16): |kernel - plain| <= 2e-2 + 2e-2 |plain| each, and
    max|kernel - plain| / max|plain| < 2e-2 each, which catches a systematic
    error of a few percent in gradients of typical size ~0.05."""
    g = torch.Generator(device="cuda").manual_seed(7 * N + C)
    q, k, v, do = (torch.randn(4, N, C, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    before = packed_attention_bwd.launches
    got = packed_attention_bwd(q, k, v, do, heads)
    torch.cuda.synchronize()
    assert packed_attention_bwd.launches == before + 1
    ref = reference_packed_attention_bwd(q, k, v, do, heads)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2, msg=name)
        rel = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        assert rel < 2e-2, (name, rel)


@pytest.mark.cuda
def test_cuda_bwd_kernel_refuses_what_it_does_not_take(card):
    q, k, v, do = (torch.randn(2, 64, 128, device="cuda").to(torch.bfloat16) for _ in range(4))
    with pytest.raises(ValueError, match="do is torch.float32"):
        packed_attention_bwd(q, k, v, do.float(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        packed_attention_bwd(q, k, v, do.transpose(1, 2).contiguous().transpose(1, 2), 4)
    with pytest.raises(ValueError, match="head dim"):
        packed_attention_bwd(q, k, v, do, 3)
    with pytest.raises(ValueError, match="multiple of 16"):
        packed_attention_bwd(*(t[:, :40] .contiguous() for t in (q, k, v, do)), 4)


@pytest.mark.cuda
def test_packed_attention_with_grad_launches_the_backward_kernel(card):
    q, k, v = (torch.randn(2, 64, 128, device="cuda").to(torch.bfloat16).requires_grad_()
               for _ in range(3))
    fwd, bwd = packed_attention.launches, packed_attention_bwd.launches
    out = packed_attention(q, k, v, 4)
    assert out.grad_fn is not None
    out.float().square().sum().backward()
    assert (packed_attention.launches - fwd, packed_attention_bwd.launches - bwd) == (1, 1)
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in (q, k, v))


@pytest.mark.cuda
def test_unet_gradients_through_the_kernel_pair_match_the_cpu(card):
    """bf16 compute on fp32 parameters: every parameter's gradient on the
    card (kernel pair) against the CPU (plain pair), relative L2 of the
    whole vector and of the attention projections' weights; one forward
    and one backward kernel launch per site."""
    from image_diffusion_torch.core.config import UNetArch
    from image_diffusion_torch.models import build_unet

    arch = UNetArch(channels=(64, 128, 128), mid_channels=(128, 128), time_dim=64,
                    num_res_layers=1, num_heads=4, num_groups=8)
    g = torch.Generator().manual_seed(0)
    state = build_unet(arch, torch.float32, "cpu", g).state_dict()
    x, noise = torch.randn(2, 32, 32, 3, generator=g), torch.randn(2, 32, 32, 3, generator=g)
    t, c, mask = torch.tensor([3, 700]), torch.tensor([0, 2]), torch.tensor([[1.0], [0.0]])
    grads = []
    for dev in ("cuda", "cpu"):
        unet = build_unet(arch, device=dev, param_dtype=torch.float32)
        unet.load_state_dict(state)
        fwd, bwd = packed_attention.launches, packed_attention_bwd.launches
        eps = unet(*(a.to(dev) for a in (x, t, c, mask)))
        torch.mean((eps.float() - noise.to(dev)) ** 2).backward()
        if dev == "cuda":
            assert (packed_attention.launches - fwd, packed_attention_bwd.launches - bwd) == (5, 5)
        grads.append({n: p.grad.float().cpu() for n, p in unet.named_parameters()})
    card_g, cpu_g = grads

    def rel(names):
        a = torch.cat([card_g[n].flatten() for n in names])
        b = torch.cat([cpu_g[n].flatten() for n in names])
        return float((a - b).norm() / b.norm())

    # both sides round to bf16 at the same points and sum in other orders;
    # a missing attention gradient gives 1.0 on the projections
    assert rel(list(cpu_g)) < 1e-1
    qkv = [n for n in cpu_g if any(f".{p}.weight" in n for p in ("to_q", "to_k", "to_v"))]
    assert len(qkv) == 15 and rel(qkv) < 1e-1


# (B, H, N, D): the VAE's mid-block site, and the kernel's other head dims
FLASH_SHAPES = [(2, 1, 1024, 384), (3, 2, 256, 128), (2, 1, 128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,N,D", FLASH_SHAPES)
def test_cuda_flash_kernel_matches_plain_version(card, B, H, N, D):
    """bf16 output: |kernel - plain| <= 2e-2 + 2e-2 |plain| and
    max|kernel - plain| / max|plain| < 2e-2."""
    from image_diffusion_torch.ops.attention import flash_attention, reference_flash_attention

    g = torch.Generator(device="cuda").manual_seed(B * N + D)
    q, k, v = (torch.randn(B, H, N, D, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    before = flash_attention.launches
    with torch.no_grad():
        got = flash_attention(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = reference_flash_attention(q, k, v, D ** -0.5)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)
    assert float((got.float() - ref.float()).abs().max() / ref.float().abs().max()) < 2e-2


@pytest.mark.cuda
def test_cuda_flash_kernel_refuses_what_it_does_not_take(card):
    from image_diffusion_torch.ops.attention import flash_attention

    q = torch.randn(2, 1, 128, 384, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        with pytest.raises(ValueError, match="bfloat16"):
            flash_attention(q.float(), q.float(), q.float(), 0.1)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(*(q[..., :320].contiguous() for _ in range(3)), 0.1)
        with pytest.raises(ValueError, match="multiple of 64"):
            flash_attention(*(q[:, :, :96].contiguous() for _ in range(3)), 0.1)
        with pytest.raises(ValueError, match="contiguous"):
            flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), q, q, 0.1)


def _tiny_flash_vae(dtype, device, param_dtype=None):
    """Both VAE attention sites at C = 128, one head, N = 8*8: the flash
    route in bf16."""
    from image_diffusion_torch.core.config import VAEArch
    from image_diffusion_torch.models import build_vae

    arch = VAEArch(channels=(16, 128), enc_num_res_blocks=1, dec_num_res_blocks=1,
                   init_resolution=16, num_groups=8)
    g = torch.Generator().manual_seed(0)
    state = build_vae(arch, torch.float32, "cpu", g).state_dict()
    model = build_vae(arch, dtype, device, param_dtype=param_dtype)
    model.load_state_dict(state)
    return model, torch.randn(2, 16, 16, 3, generator=g), torch.randn(2, 8, 8, 3, generator=g)


@pytest.mark.cuda
def test_vae_forward_launches_the_flash_kernel_at_both_sites(card):
    from image_diffusion_torch import ops
    from image_diffusion_torch.ops.attention import flash_attention

    model, x, noise = _tiny_flash_vae(torch.bfloat16, "cuda")
    ref_model, _, _ = _tiny_flash_vae(torch.bfloat16, "cpu")
    before = flash_attention.launches
    with torch.inference_mode(), ops.record_sites() as sites:
        out, _, _ = model(x.cuda(), sample=True, noise=noise.cuda())
        ref, _, _ = ref_model(x, sample=True, noise=noise)
    assert flash_attention.launches - before == 2
    assert [s[-1] for s in sites] == ["flash"] * 4  # two sites, card then CPU
    assert float((out.float().cpu() - ref.float()).norm() / ref.float().norm()) < 5e-2


@pytest.mark.cuda
def test_vae_gradients_through_flash_attention_match_the_cpu(card):
    """bf16 compute on fp32 parameters: the to_q/to_k/to_v weights of both
    sites get a nonzero gradient through `FlashAttention` on the card, close
    to the CPU's (plain version): relative L2 < 0.1 (other summation orders
    at bf16; a lost attention gradient gives 1.0)."""
    from image_diffusion_torch.ops.attention import flash_attention

    grads = []
    for dev in ("cuda", "cpu"):
        model, x, noise = _tiny_flash_vae(torch.bfloat16, dev, param_dtype=torch.float32)
        before = flash_attention.launches
        out, prior, _ = model(x.to(dev), sample=True, noise=noise.to(dev))
        (out.float().square().mean() + prior).backward()
        if dev == "cuda":
            assert flash_attention.launches - before == 2
        grads.append({n: p.grad.float().cpu() for n, p in model.named_parameters()
                      if any(f".{w}.weight" in n for w in ("to_q", "to_k", "to_v"))})
    card_g, cpu_g = grads
    assert len(cpu_g) == 6
    for n in cpu_g:
        assert card_g[n].abs().sum() > 0, n
        assert float((card_g[n] - cpu_g[n]).norm() / cpu_g[n].norm()) < 1e-1, n
