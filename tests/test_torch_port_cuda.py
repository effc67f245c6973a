"""The port's CUDA kernels against their plain versions, on the card, and
the UNet's and the VAE's attention gradients through them against the CPU.

Imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda --noconftest

Without a card every test skips.
"""

import pytest
import torch

from image_diffusion_torch.ops import group_norm, group_norm_bwd
from image_diffusion_torch.ops.attention import (
    packed_attention,
    packed_attention_bwd,
    packed_attention_with_row_sum,
    reference_packed_attention,
    reference_packed_attention_bwd,
)

# the UNet sites; ragged Q tiles (N=48 < 64, N=80 not a multiple of 64) and
# N=144 and N=192 above 128 but no multiple of it, which stay on the
# mma.sync kernels; d=64 on the wgmma kernels
UNET_SITES = [(1024, 256, 8), (1024, 128, 8), (256, 384, 8), (256, 256, 8),
              (64, 512, 8), (64, 384, 8), (16, 512, 8)]
SITES = UNET_SITES + [(48, 128, 4), (80, 64, 4), (144, 64, 2), (192, 96, 2), (128, 128, 2)]


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
@pytest.mark.parametrize("N,C,heads", UNET_SITES)
def test_cuda_kernel_row_sums_match_plain_version(card, N, C, heads):
    """The fp32 row sums the forward hands to the backward: the same fp32
    weights summed in another order, 1e-3 relative; and the output beside
    them is the one the kernel gives without them."""
    g = torch.Generator(device="cuda").manual_seed(N + C)
    q, k, v = (torch.randn(4, N, C, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    before = packed_attention.launches
    out, row_sum = packed_attention_with_row_sum(q, k, v, heads)
    torch.cuda.synchronize()
    assert packed_attention.launches == before + 1
    assert row_sum.dtype == torch.float32 and row_sum.shape == (4, heads, N)
    _, ref = reference_packed_attention(q, k, v, heads, return_row_sum=True)
    torch.testing.assert_close(row_sum, ref, atol=0, rtol=1e-3)
    with torch.no_grad():
        assert torch.equal(out, packed_attention(q, k, v, heads))


@pytest.mark.cuda
def test_cuda_kernel_without_grad_writes_no_row_sums(card):
    """Under no_grad the kernel gets a null row_sum pointer: same output,
    and nothing allocated beside it (the sampler pays nothing)."""
    q, k, v = (torch.randn(2, 256, 128, device="cuda").to(torch.bfloat16) for _ in range(3))
    with_sums, _ = packed_attention_with_row_sum(q, k, v, 4)
    torch.cuda.synchronize()
    with torch.no_grad():
        packed_attention(q, k, v, 4)  # the library is loaded, the allocator warm
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        out = packed_attention(q, k, v, 4)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() - allocated == out.numel() * out.element_size()
    assert out.grad_fn is None and torch.equal(out, with_sums)


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
@pytest.mark.parametrize("N,C,heads", SITES)
def test_cuda_bwd_through_the_function_equals_the_backward_called_alone(card, N, C, heads):
    """The forward operator hands its output and row sums to the
    backward; called alone the wrapper launches the forward first.  The
    same kernels on the same statistics: equal bit for bit, and every
    launch of the forward kernel is counted, the wrapper's own too."""
    g = torch.Generator(device="cuda").manual_seed(11 * N + C)
    q, k, v, do = (torch.randn(3, N, C, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    fwd, bwd = packed_attention.launches, packed_attention_bwd.launches
    alone = packed_attention_bwd(q, k, v, do, heads)
    assert (packed_attention.launches - fwd, packed_attention_bwd.launches - bwd) == (1, 1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    packed_attention(*leaves, heads).backward(do)
    torch.cuda.synchronize()
    assert (packed_attention.launches - fwd, packed_attention_bwd.launches - bwd) == (2, 2)
    for name, a, leaf in zip(("dq", "dk", "dv"), alone, leaves):
        assert torch.equal(a, leaf.grad), name
    out, row_sum = packed_attention_with_row_sum(q, k, v, heads)
    for name, a, b in zip(("dq", "dk", "dv"), alone,
                          packed_attention_bwd(q, k, v, do, heads, out, row_sum)):
        assert torch.equal(a, b), name


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
    out, row_sum = packed_attention_with_row_sum(q, k, v, 4)
    with pytest.raises(ValueError, match="both out and row_sum"):
        packed_attention_bwd(q, k, v, do, 4, out=out)
    with pytest.raises(ValueError, match="out is torch.float32"):
        packed_attention_bwd(q, k, v, do, 4, out.float(), row_sum)
    with pytest.raises(ValueError, match="row_sum must be"):
        packed_attention_bwd(q, k, v, do, 4, out, row_sum.double())
    with pytest.raises(ValueError, match="row_sum must be"):
        packed_attention_bwd(q, k, v, do, 4, out, row_sum[:, :2].contiguous())


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


# (B, H, N, D): the VAE's mid-block site, the grid's decode batch at it, an
# odd number of 64-key tiles (the last one scored by the first warpgroup),
# and the kernel's other head dims
FLASH_SHAPES = [(2, 1, 1024, 384), (27, 1, 1024, 384), (2, 1, 192, 384), (3, 2, 256, 128),
                (2, 1, 128, 256)]


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


@pytest.mark.cuda
def test_vq_vae_train_forward_launches_flash_and_updates_the_codebook(card):
    """A tiny VQ VAE's train-mode forward at batch 2 on the card (bf16
    compute on fp32 parameters) launches the flash kernel at both sites,
    and its one EMA update matches the float64 statement of the update on
    the same codes and tokens: cluster sizes, ema_w and embeddings at
    max|card - fp64| / max|fp64| <= 1e-4 (fp32 sums in any order)."""
    from image_diffusion_torch.core.config import VAEArch
    from image_diffusion_torch.models import build_vae
    from image_diffusion_torch.models.vae import nearest_code
    from image_diffusion_torch.ops.attention import flash_attention

    arch = VAEArch(channels=(16, 128), z_dim=3, bottleneck="vq", codebook_size=64,
                   codebook_beta=0.25, codebook_gamma=0.99, enc_num_res_blocks=1,
                   dec_num_res_blocks=1, init_resolution=16, num_groups=8)
    g = torch.Generator().manual_seed(0)
    model = build_vae(arch, torch.bfloat16, "cuda", g, param_dtype=torch.float32)
    x = torch.randn(2, 16, 16, 3, generator=g).cuda()
    cb = model.codebook
    cs0, w0, emb0 = (t.clone() for t in (cb.ema_cluster_size, cb.ema_w, cb.embeddings.weight))
    seen = []
    cb.register_forward_pre_hook(lambda m, args: seen.append(args[0].detach().clone()))
    before = flash_attention.launches
    out, prior, perplexity = model(x, train=True)
    torch.cuda.synchronize()
    assert flash_attention.launches - before == 2
    assert out.shape == (2, 16, 16, 3) and torch.isfinite(out.float()).all()
    flat = seen[0].reshape(-1, 3).float()
    idx = nearest_code(flat, emb0)
    counts = torch.bincount(idx, minlength=64).double()
    dw = torch.zeros(64, 3, dtype=torch.float64, device="cuda").index_add_(0, idx, flat.double())
    cs = cs0.double() * 0.99 + 0.01 * counts
    n = cs.sum()
    smoothed = (cs + 1e-5) / (n + 64 * 1e-5) * n
    w = w0.double() * 0.99 + 0.01 * dw
    for got, ref in ((cb.ema_cluster_size, smoothed), (cb.ema_w, w),
                     (cb.embeddings.weight, w / smoothed[:, None])):
        assert got.dtype == torch.float32
        assert float((got.double() - ref).abs().max() / ref.abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dots", "full"])
def test_remat_step_launches_each_packed_kernel_once_a_site(card, mode):
    """The full-width UNet at batch 2, bf16 compute on fp32 parameters: a
    forward and backward under `mode` launch the forward and the backward
    kernel 14 times each (the forward's output is saved, never
    recomputed), and the gradients equal the plain module's to 1e-3
    relative L2 (the recomputed GroupNorm operators are the same kernels
    on the same inputs; cuDNN's backward may sum in another order).  The
    GroupNorm forward kernels run once a norm (43) without remat and again
    for the 42 inside the blocks under `mode`, the backward's once a norm."""
    from image_diffusion_torch.core.config import UNetArch
    from image_diffusion_torch.models import build_unet

    g = torch.Generator().manual_seed(4)
    state = build_unet(UNetArch(), torch.float32, "cpu", g).state_dict()
    x, noise = torch.randn(2, 32, 32, 3, generator=g), torch.randn(2, 32, 32, 3, generator=g)
    args = [a.cuda() for a in (x, torch.tensor([3, 700]), torch.tensor([0, 2]),
                               torch.tensor([[1.0], [0.0]]))]
    grads = {}
    for remat in (None, mode):
        unet = build_unet(UNetArch(), device="cuda", param_dtype=torch.float32, remat=remat)
        unet.load_state_dict(state)
        fwd, bwd = packed_attention.launches, packed_attention_bwd.launches
        gn_fwd, gn_bwd = group_norm.launches, group_norm_bwd.launches
        torch.mean((unet(*args).float() - noise.cuda()) ** 2).backward()
        torch.cuda.synchronize()
        assert (packed_attention.launches - fwd, packed_attention_bwd.launches - bwd) == (14, 14)
        norms = (group_norm.launches - gn_fwd, group_norm_bwd.launches - gn_bwd)
        assert norms == ((43, 43) if remat is None else (85, 43))
        grads[remat] = torch.cat([p.grad.float().flatten() for p in unet.parameters()])
    rel = float((grads[mode] - grads[None]).norm() / grads[None].norm())
    assert rel <= 1e-3, rel


@pytest.mark.cuda
def test_inception_features_on_the_card_match_the_cpu_in_fp32(card):
    """The FID Inception on random weights (tests/torch_oracles.py), two
    64x64 images: the card's features against the CPU's at 1e-4 of the
    largest (fp32 throughout, TF32 off inside the call; with TF32 the error
    is about three digits' worth); the call leaves the TF32 switch as it
    found it."""
    from torch_oracles import random_inception

    from image_diffusion_torch.models.inception import InceptionV3Features

    state = random_inception(0).state_dict()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    feats = []
    for dev in ("cuda", "cpu"):
        model = InceptionV3Features().to(dev).eval()
        model.load_state_dict(state)
        saved = torch.backends.cudnn.allow_tf32
        feats.append(model(x.to(dev)).cpu())
        assert torch.backends.cudnn.allow_tf32 == saved
    card_f, cpu_f = feats
    assert card_f.shape == (2, 2048) and card_f.dtype == torch.float32
    assert float((card_f - cpu_f).abs().max() / cpu_f.abs().max()) <= 1e-4


@pytest.mark.cuda
def test_pipeline_on_the_card_samples_with_its_own_models_sharded_or_not(card):
    """A pipeline on "cuda" (no index) samples with its own models, never a
    copy of them, unsharded and over ["cuda:0", "cuda:0"], so a change to
    its weights in place (as the trainer's preview makes) reaches both;
    the sharded grid stays the unsharded one's (fp32 on both sides; cuDNN's
    TF32 convolutions at another row count: 1e-2 relative L2)."""
    from image_diffusion_torch.core.config import ScheduleConfig, UNetArch, VAEArch
    from image_diffusion_torch.models import build_unet, build_vae
    from image_diffusion_torch.pipelines import DiffusionPipeline

    vae_arch = VAEArch(in_channels=3, channels=(8, 16), z_dim=3, enc_num_res_blocks=1,
                       dec_num_res_blocks=1, attn_resolutions=(), num_heads=2,
                       init_resolution=16, num_groups=4)
    unet_arch = UNetArch(z_dim=3, channels=(8, 16), mid_channels=(16, 16), time_dim=16,
                         num_res_layers=1, num_heads=2, num_groups=4, num_classes=3)
    g = torch.Generator().manual_seed(3)
    pipe = DiffusionPipeline(vae_arch, build_vae(vae_arch, torch.float32, "cpu", g).state_dict(),
                             unet_arch, build_unet(unet_arch, torch.float32, "cpu", g).state_dict(),
                             ScheduleConfig(num_steps=8), "a,b,c", dtype=torch.float32,
                             device="cuda")

    def grids():
        kw = dict(seed=0, sampler="dpm", num_inference_steps=3)
        return pipe.sample([1.0, 2.0], **kw), pipe.sample([1.0, 2.0], devices=["cuda:0"] * 2, **kw)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    one, two = grids()
    with torch.no_grad():
        for p in pipe.unet.parameters():
            p.mul_(0.5)
    one_after, two_after = grids()
    assert not pipe._replicas
    assert rel(one_after, one) > 1e-2
    assert rel(two, one) <= 1e-2 and rel(two_after, one_after) <= 1e-2
