"""DiT-XL/2 and the KL-f8 decoder on the CPU at a small size (depth 2,
hidden 144, 2 heads of 72, patch 2, an 8x8x4 latent, 10 classes; a
3-level ldm decoder), on seeded random weights, against the benchmark's
plain fp32 reference (`benchmark/reference/dit.py`, loaded by path): the
forwards, the pipeline's DDIM steps, the bundle through the sampling CLIs,
and what the DiT changed around it (the d = 72 route, the beta-linear
schedule, GroupNorm's eps)."""

import numpy as np
import pytest
import torch

import dit_reference
from image_diffusion_torch import ops
from image_diffusion_torch.core.config import DiTArch, DiTConfig, ScheduleConfig, VAEArch
from image_diffusion_torch.models import build_denoiser, build_vae
from image_diffusion_torch.models.layers import GroupNorm
from image_diffusion_torch.ops import schedule as S
from image_diffusion_torch.pipelines import DiffusionPipeline
from image_diffusion_torch.scripts import eval_fid, sample_grid, serve
from torch_oracles import random_inception

ref, nets, lowp = dit_reference.load("dit"), dit_reference.load("nets"), dit_reference.load("lowp")

SMALL = DiTArch(input_size=8, patch_size=2, hidden_size=144, depth=2, num_heads=2,
                num_classes=10)
DECODER = VAEArch(channels=(32, 64, 64), z_dim=4, init_resolution=32, num_groups=8,
                  layout="ldm", latent_scale=0.18215)
SCHEDULE = ScheduleConfig(noise_type="beta-linear", clip_denoised=False)
# fp32: the same sums in another order
FP32 = 1e-5
# bf16 against the fp32 reference on the same (bf16-rounded) weights: the DiT
# reads 5.5-6.2e-3 and the decoder 1.9-2.5e-2 over seeds 1-3; the fp8
# control (the benchmark's `lowp.fp8` in every product) reads 4.8-5.4e-2 and
# 0.17-0.23, so each bound sits ~3x above bf16 and ~2.5x below fp8
BF16 = {"dit": 2e-2, "decoder": 6e-2}


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def arch_dict(arch) -> dict:
    d = arch.to_dict()
    d["channels"] = list(d.get("channels", []))
    return d


def dit_model(dtype, seed=7):
    P = ref.dit_weights(arch_dict(SMALL), seed, "cpu", dtype)
    model = build_denoiser(SMALL, dtype, "cpu")
    model.load_state_dict(P)
    return model, {k: v.float() for k, v in P.items()}


def decoder_model(dtype, seed=8):
    P = nets.make_weights(ref.ldm_decoder_leaves(arch_dict(DECODER)), seed, "cpu", dtype)
    vae = build_vae(DECODER, dtype, "cpu")
    vae.load_state_dict(P)
    return vae, {k: v.float() for k, v in P.items()}


def inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(6, 8, 8, 4, generator=g), torch.tensor([999, 900, 500, 100, 10, 0]),
            torch.tensor([0, 3, 9, 10, 1, 10]))


def run_dit(dtype, q=nets.ident):
    model, P = dit_model(dtype)
    x, t, y = inputs()
    with torch.no_grad():
        got = model(x, t, y)
    return got, ref.dit(P, arch_dict(SMALL), x, t, y), ref.dit(P, arch_dict(SMALL), x, t, y, q=q)


def run_decoder(dtype, q=nets.ident):
    vae, P = decoder_model(dtype)
    z = torch.randn(3, 8, 8, 4, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = vae.decode(z)
    return got, ref.ldm_decode(P, arch_dict(DECODER), z), ref.ldm_decode(P, arch_dict(DECODER),
                                                                          z, q=q)


@pytest.mark.parametrize("part", ["dit", "decoder"])
def test_port_matches_the_reference_in_fp32(part):
    got, want, _ = (run_dit if part == "dit" else run_decoder)(torch.float32)
    assert got.shape == want.shape and rel(got, want) < FP32


@pytest.mark.parametrize("part", ["dit", "decoder"])
def test_bf16_holds_its_bound_and_fp8_products_do_not(part):
    got, want, control = (run_dit if part == "dit" else run_decoder)(torch.bfloat16, lowp.fp8)
    assert got.dtype == torch.bfloat16
    assert rel(got, want) < BF16[part] < rel(control, want)


def test_dit_xl2_config_builds_every_published_size():
    cfg = DiTConfig.from_yaml("configs/dit-xl2-256.yaml")
    a = cfg.arch
    assert (a.depth, a.hidden_size, a.num_heads, a.patch_size, a.out_channels) == (28, 1152, 16, 2, 32 // 4)
    assert a.hidden_size // a.num_heads == 72 and a.num_classes + 1 == 1001
    assert cfg.vae.layout == "ldm" and cfg.vae.latent_resolution == 32
    assert cfg.vae.latent_scale == 0.18215 and cfg.schedule.noise_type == "beta-linear"
    with torch.device("meta"):
        from image_diffusion_torch.models.dit import DiT
        model = DiT(a)
    assert len(model.blocks) == 28 and model.final_layer.linear.out_features == 2 * 2 * 8
    assert model.y_embedder.embedding_table.num_embeddings == 1001
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(l.shape)) for l in ref.dit_leaves(arch_dict(a)))
    assert 674e6 < n < 676e6


def test_no_layer_is_zero_at_set_up():
    """Every weight is drawn from the seed, the adaLN modulation and final
    layers included (DiT's adaLN-Zero would zero every gate and the
    output, and the model would be the identity)."""
    model = build_denoiser(SMALL, torch.float32, "cpu", torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        assert p.abs().amax() > 0, name
    names = [n for n, _ in model.named_parameters()]
    assert "blocks.0.adaLN_modulation.1.weight" in names and "final_layer.linear.weight" in names
    assert all(leaf.init[0] != "const" for leaf in ref.dit_leaves(arch_dict(SMALL)))
    x, t, y = inputs()
    with torch.no_grad():
        assert rel(model(x, t, y)[..., :4], x) > 0.5


def test_a_zero_mask_is_the_null_class():
    model, _ = dit_model(torch.float32)
    x, t, y = inputs()
    y = y.clamp(max=9)
    null = torch.full_like(y, SMALL.num_classes)
    with torch.no_grad():
        masked = model(x, t, y, torch.zeros(6, 1))
        assert torch.equal(masked, model(x, t, null))
        assert torch.equal(masked, model(x, t))
        assert torch.equal(model(x, t, y, torch.ones(6, 1)), model(x, t, y))
        assert not torch.equal(masked, model(x, t, y))


def test_d72_sites_take_the_forward_kernel_without_grad_only():
    assert ops.site_route(256, 1152, 16, torch.bfloat16) == "plain"  # grad is on in a test
    with torch.no_grad():
        assert ops.site_route(256, 1152, 16, torch.bfloat16) == "kernel"
        assert ops.site_route(16, 144, 2, torch.bfloat16) == "kernel"
        assert ops.site_route(256, 1152, 16, torch.float32) == "plain"
        assert ops.site_route(24, 144, 2, torch.bfloat16) == "plain"  # N not a multiple of 16
        assert ops.site_route(1024, 512, 1, torch.bfloat16) == "plain"  # the decoder's d = 512
    with torch.enable_grad():
        assert ops.site_route(256, 1152, 16, torch.bfloat16) == "plain"
        assert ops.site_route(256, 512, 8, torch.bfloat16) == "kernel"  # d = 64 keeps both ways


def test_schedules():
    """beta-linear is DiT's np.linspace(1e-4, 0.02, 1000); "linear" keeps its
    scaled-linear tables bit for bit."""
    bl = S.make_schedule(1000, 1e-4, 0.02, "beta-linear")
    betas = np.linspace(1e-4, 0.02, 1000, dtype=np.float64)
    np.testing.assert_array_equal(bl.betas.numpy(), betas.astype(np.float32))
    np.testing.assert_array_equal(bl.alpha_cum_prod.numpy(),
                                  np.cumprod(1.0 - betas).astype(np.float32))
    np.testing.assert_array_equal(bl.alpha_cum_prod.numpy(), ref.alpha_bars(SCHEDULE.to_dict()))
    lin = S.make_schedule(1000, 1e-4, 0.02, "linear")
    scaled = np.linspace(1e-4 ** 0.5, 0.02 ** 0.5, 1000, dtype=np.float64) ** 2
    np.testing.assert_array_equal(lin.betas.numpy(), scaled.astype(np.float32))
    np.testing.assert_array_equal(lin.alpha_cum_prod.numpy(),
                                  np.cumprod(1.0 - scaled).astype(np.float32))


def test_group_norm_takes_its_eps_and_keeps_1e_5_by_default():
    g = torch.Generator().manual_seed(3)
    x = 1e-3 * torch.randn(2, 32, 4, 4, generator=g, dtype=torch.float64)
    w, b = torch.rand(32, generator=g) + 0.5, torch.randn(32, generator=g)
    for eps in (1e-6, 1e-5):
        want = torch.nn.functional.group_norm(x, 8, w.double(), b.double(), eps)
        got = ops.reference_group_norm(x.float(), w, b, 8, eps=eps)
        assert rel(got, want) < 1e-5
        m = GroupNorm(8, 32, eps=eps)
        m.weight.data, m.bias.data = w.clone(), b.clone()
        assert torch.equal(m(x.float()), got)
    assert GroupNorm(8, 32).eps == 1e-5
    assert torch.equal(ops.reference_group_norm(x.float(), w, b, 8),
                       ops.reference_group_norm(x.float(), w, b, 8, eps=1e-5))


def small_pipeline(dtype=torch.float32) -> DiffusionPipeline:
    model, _ = dit_model(dtype)
    vae, _ = decoder_model(dtype)
    return DiffusionPipeline(DECODER, vae.state_dict(), SMALL, model.state_dict(), SCHEDULE,
                             [str(i) for i in range(10)], dtype=dtype, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pipeline_ddim_steps_follow_the_reference_update(dtype):
    """Each of the pipeline's DDIM steps from its own state against the
    reference's guided update, and the decode of its final latent over the
    latent scale.  fp32: |program next - reference next| within 1e-5 of
    |reference next| (rounding: unclipped, random weights grow the states
    to ~10^4 times the last step, so a step's own size is no scale for
    fp32); bf16: the benchmark's step gap, |program next - reference next|
    / |reference next - state|, under 0.1, where bf16 reads ~5e-3 and the
    fp8 control ~4e-2 (the benchmark's cell at this size)."""
    pipe = small_pipeline(dtype)
    states, finals = [], []
    pipe.unet.register_forward_pre_hook(lambda m, args: states.append(args[0][:3].float()))
    decode = pipe.vae.decode
    pipe.vae.decode = lambda z, **kw: finals.append(z.float()) or decode(z, **kw)
    labels, scales = torch.tensor([1, 5, 9]), torch.tensor([1.5, 1.5, 4.0])
    x0 = torch.randn(3, 8, 8, 4, generator=torch.Generator().manual_seed(4))
    images = pipe.sample_batch(labels, scales, x0, sampler="ddim", num_inference_steps=5)
    assert images.shape == (3, 32, 32, 3) and len(states) == 5
    chain = states + [finals[0] * DECODER.latent_scale]
    assert torch.equal(chain[0], x0)
    a, acp = arch_dict(SMALL), ref.alpha_bars(SCHEDULE.to_dict())
    ts = ref.ddim_timesteps(1000, 5)
    _, P = dit_model(dtype)
    for i, (t, t_prev) in enumerate(zip(ts, ts[1:] + [-1])):
        nxt = ref.ddim_update(P, a, acp, chain[i], torch.full((3,), t), torch.full((3,), t_prev),
                              labels, scales)
        scale = nxt if dtype == torch.float32 else nxt - chain[i]
        gap = (chain[i + 1] - nxt).flatten(1).norm(dim=1) / scale.flatten(1).norm(dim=1)
        assert float(gap.max()) < (FP32 if dtype == torch.float32 else 0.1), (i, gap)
    _, Pv = decoder_model(dtype)
    decoded = ref.ldm_decode(Pv, arch_dict(DECODER), finals[0])
    assert rel(images, decoded) < (FP32 if dtype == torch.float32 else BF16["decoder"])


def test_learned_sigma_refuses_the_ddpm_sampler():
    pipe = small_pipeline()
    with pytest.raises(ValueError, match="learned posterior variance"):
        pipe.sample_batch([0], [1.0], torch.randn(1, 8, 8, 4), sampler="ddpm")
    pipe.sample_batch([0], [1.0], torch.randn(1, 8, 8, 4), sampler="dpm", num_inference_steps=2)


def test_a_dit_bundle_samples_through_sample_grid_eval_fid_and_serve(tmp_path, capsys):
    """A DiT bundle written and read back holds the same weights and
    schedule; `sample_grid --sampler ddim` gives `pipe.sample`'s images,
    `eval_fid` scores its samples and `serve`'s engine serves a batch."""
    pipe = small_pipeline()
    path = str(tmp_path / "dit.ckpt")
    pipe.to_checkpoint(path)
    back = DiffusionPipeline.from_checkpoint(path, dtype=torch.float32, device="cpu")
    assert isinstance(back.unet_arch, DiTArch) and back.unet_arch == SMALL
    assert back.vae_arch == DECODER and back.schedule_cfg == SCHEDULE
    for mine, theirs in ((pipe.unet, back.unet), (pipe.vae, back.vae)):
        for (k, v), (k2, v2) in zip(mine.state_dict().items(), theirs.state_dict().items()):
            assert k == k2 and torch.equal(v, v2)

    out = tmp_path / "grid.png"
    argv = [path, "--device", "cpu", "--sampler", "ddim", "--steps", "2", "--cfg", "1", "2",
            "--seed", "0", "--out", str(out)]
    sample_grid.main(argv)
    assert out.stat().st_size > 0
    _, _, images, _ = sample_grid.sample(sample_grid.parse_args(argv))
    want = DiffusionPipeline.from_checkpoint(path, device="cpu").sample(
        [1], seed=0, sampler="ddim", num_inference_steps=2)
    assert images.shape == (10, 32, 32, 3)
    torch.testing.assert_close(images, want, atol=0, rtol=0)

    weights = tmp_path / "inception.pth"
    torch.save(random_inception(0).state_dict(), weights)
    real = tmp_path / "real.npy"
    np.save(real, np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8))
    eval_fid.main([path, "--real", str(real), "--fid-weights", str(weights), "--num-images", "2",
                   "--batch", "10", "--sampler", "ddim", "--steps", "1", "--device", "cpu"])
    assert np.isfinite(float(capsys.readouterr().out.strip().splitlines()[-1]))

    import argparse
    engine = serve.Engine(argparse.Namespace(model=path, host="127.0.0.1", port=0, batch_size=2,
                                             linger_ms=1.0, sampler="ddim", steps=2, eta=0.0,
                                             device="cpu", data_parallel=None))
    got = engine._run([5, 6], [0, 9], [1.5, 4.0])
    gens = engine._row_generators([5, 6])
    x_init = torch.stack([torch.randn((8, 8, 4), generator=g) for g in gens])
    want = engine.pipe.sample_batch([0, 9], [1.5, 4.0], x_init, sampler="ddim",
                                    num_inference_steps=2, row_generators=gens, output="uint8")
    assert got.shape == (2, 32, 32, 3) and torch.equal(got, want)
