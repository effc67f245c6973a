"""The port's UNet and VAE: the original PyTorch goldens loaded with a
plain `load_state_dict`, and the tiny models against flax on the same
weights (fp32 at 2e-4; one bf16 comparison at its stated bar)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_diffusion_tpu.core import checkpoint as jckpt
from image_diffusion_tpu.core.config import UNetArch as JUNetArch
from image_diffusion_tpu.core.config import VAEArch as JVAEArch
from image_diffusion_tpu.models import UNet as JUNet
from image_diffusion_tpu.models import VAE as JVAE
from image_diffusion_tpu.models import io as jio
from image_diffusion_torch.compat.from_jax import (
    unet_flax_params,
    unet_state_dict,
    vae_flax_variables,
    vae_state_dict,
)
from image_diffusion_torch.core.config import UNetArch, VAEArch
from image_diffusion_torch.models import build_unet, build_vae
from image_diffusion_torch.models.io import load_unet, load_vae
from image_diffusion_torch.models.unet import UNet
from image_diffusion_torch.models.vae import VAE

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
ATOL = 2e-4

UNET_TINY = dict(z_dim=3, channels=(16, 32, 32), mid_channels=(32, 32), time_dim=32,
                 num_res_layers=1, num_heads=2, num_groups=8, num_classes=3)
VAE_TINY = dict(in_channels=3, channels=(16, 32), z_dim=3, enc_num_res_blocks=1,
                dec_num_res_blocks=1, attn_resolutions=(32,), num_heads=2,
                init_resolution=32, num_groups=8)
VQ = dict(bottleneck="vq", codebook_size=32, codebook_beta=0.25, codebook_gamma=0.99)


def _golden(name):
    data = np.load(os.path.join(GOLDENS, name))
    state = {k[len("state::"):]: torch.from_numpy(data[k]) for k in data.files if k.startswith("state::")}
    return state, {k: data[k] for k in data.files if not k.startswith("state::")}


def nhwc(x):
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


def test_param_counts_at_full_size():
    with torch.device("meta"):
        unet, vae = UNet(UNetArch()), VAE(VAEArch())
    assert sum(p.numel() for p in unet.parameters()) == 60_475_523
    assert sum(p.numel() for p in vae.parameters()) == 36_319_935


def test_unet_golden():
    state, g = _golden("unet_tiny.npz")
    model = build_unet(UNetArch(**UNET_TINY), torch.float32, "cpu")
    model.load_state_dict(state)
    x = torch.from_numpy(nhwc(g["x"]))
    t, c, mask = (torch.from_numpy(g[k]) for k in ("t", "c", "mask"))
    with torch.no_grad():
        cond = model(x, t, c, mask).numpy()
        uncond = model(x, t).numpy()
    np.testing.assert_allclose(cond, nhwc(g["out_cond"]), atol=ATOL)
    np.testing.assert_allclose(uncond, nhwc(g["out_uncond"]), atol=ATOL)


def test_kl_vae_golden():
    state, g = _golden("vae_kl_tiny.npz")
    model = build_vae(VAEArch(**VAE_TINY), torch.float32, "cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        z = model.encode(torch.from_numpy(nhwc(g["x"])))[0]
        x_hat = model.decode(z[..., :3].contiguous())
    np.testing.assert_allclose(z.numpy(), nhwc(g["z_raw"]), atol=ATOL)
    np.testing.assert_allclose(x_hat.numpy(), nhwc(g["x_hat"]), atol=ATOL)


def test_vq_vae_golden():
    state, g = _golden("vae_vq_tiny.npz")
    model = build_vae(VAEArch(**VAE_TINY, **VQ), torch.float32, "cpu")
    model.load_state_dict(state)
    with torch.no_grad():
        x_hat = model.decode(model.encode(torch.from_numpy(nhwc(g["x"])))[0], quantize=True)
    np.testing.assert_allclose(x_hat.numpy(), nhwc(g["x_hat"]), atol=ATOL)


def _unet_inputs(B=3, res=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, res, res, 3)).astype(np.float32)
    return x, np.array([0, 500, 999][:B], np.int32), np.array([0, 2, 1][:B], np.int32)


def _flax_unet(dtype):
    model = JUNet(**UNET_TINY, dtype=dtype)
    x, t, c = _unet_inputs()
    variables = jax.jit(lambda: model.init(jax.random.key(0), x, t, c))()
    return model, jax.tree.map(np.asarray, variables)


def test_tiny_unet_matches_flax_fp32():
    jmodel, variables = _flax_unet(jnp.float32)
    x, t, c = _unet_inputs()
    mask = np.array([[1.0], [0.0], [1.0]], np.float32)
    ref = np.asarray(jax.jit(jmodel.apply)(variables, x, t, c, mask))
    model = build_unet(UNetArch(**UNET_TINY), torch.float32, "cpu")
    model.load_state_dict(unet_state_dict(variables["params"]))
    tx, tt, tc = torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c)
    with torch.no_grad():
        out = model(tx, tt, tc, torch.from_numpy(mask))
        # mask 0 is exactly context=None: the 2x-batched CFG identity
        masked = model(tx, tt, tc, torch.zeros(3, 1))
        none = model(tx, tt)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    torch.testing.assert_close(masked, none, atol=0, rtol=0)
    # the flax tree round-trips through the state dict exactly
    back = unet_flax_params(model.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, variables["params"])


def test_tiny_unet_matches_flax_bf16():
    """bf16 on both sides: bf16 activations and weights, and the port's
    attention sites take the kernel route (its plain version here) while
    JAX on the CPU takes the einsum route.  Bar: max |diff| <= 5e-2 of
    the output's max |value| (about 12 bf16 ulps at the output scale)."""
    jmodel, variables = _flax_unet(jnp.bfloat16)
    x, t, c = _unet_inputs()
    ref = np.asarray(jax.jit(jmodel.apply)(variables, x, t, c).astype(jnp.float32))
    model = build_unet(UNetArch(**UNET_TINY), torch.bfloat16, "cpu")
    model.load_state_dict(unet_state_dict(variables["params"]))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(c))
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= 5e-2 * np.abs(ref).max(), (err, np.abs(ref).max())


def _assert_state_equal(model, expected):
    state = model.state_dict()
    assert set(state) == set(expected)
    for k, v in expected.items():
        torch.testing.assert_close(state[k], v, atol=0, rtol=0)


def test_load_model_files_written_by_jax(tmp_path):
    """`models.io` reads the JAX package's per-model files and its trainer
    epoch checkpoints (raw params under the model key, the VQ codebook a
    sibling tree) into the same weights."""
    _, unet_vars = _flax_unet(jnp.float32)
    vae_arch = JVAEArch(**VAE_TINY, **VQ)
    vae_vars = jax.tree.map(np.asarray, JVAE(**VAE_TINY, **VQ, dtype=jnp.float32).init(
        {"params": jax.random.key(1)}, np.zeros((1, 32, 32, 3), np.float32), sample=False))
    unet_file, unet_epoch = str(tmp_path / "unet.ckpt"), str(tmp_path / "unet-epoch-00.ckpt")
    vae_file, vae_epoch = str(tmp_path / "vae.ckpt"), str(tmp_path / "vae-epoch-00.ckpt")
    jio.save_unet(unet_file, JUNetArch(**UNET_TINY), unet_vars)
    jckpt.save_checkpoint(unet_epoch, architecture=JUNetArch(**UNET_TINY).to_dict(), epoch=0,
                          unet=unet_vars["params"])
    jio.save_vae(vae_file, vae_arch, vae_vars)
    jckpt.save_checkpoint(vae_epoch, architecture=vae_arch.to_dict(), epoch=0,
                          vae=vae_vars["params"], codebook=vae_vars["codebook"])
    for path in (unet_file, unet_epoch):
        model, arch = load_unet(path, torch.float32, "cpu")
        assert arch == UNetArch(**UNET_TINY)
        _assert_state_equal(model, unet_state_dict(unet_vars["params"]))
    for path in (vae_file, vae_epoch):
        model, arch = load_vae(path, torch.float32, "cpu")
        assert arch == VAEArch(**VAE_TINY, **VQ)
        _assert_state_equal(model, vae_state_dict(vae_vars))


@pytest.mark.parametrize("vq", [False, True], ids=["kl", "vq"])
def test_tiny_vae_matches_flax_fp32(vq):
    arch_kw = dict(VAE_TINY, **(VQ if vq else {}))
    jmodel = JVAE(**arch_kw, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    z = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    variables = jax.jit(lambda: jmodel.init({"params": jax.random.key(0)}, x, sample=False))()
    variables = jax.tree.map(np.asarray, variables)
    ref_dec = np.asarray(jax.jit(lambda v, z: jmodel.apply(v, z, vq, method="decode"))(variables, z))
    ref_enc = jax.jit(lambda v, x: jmodel.apply(v, x, sample=False, method="encode"))(variables, x)

    model = build_vae(VAEArch(**arch_kw), torch.float32, "cpu")
    model.load_state_dict(vae_state_dict(variables))
    with torch.no_grad():
        dec = model.decode(torch.from_numpy(z), quantize=vq).numpy()
        enc, prior, perplexity = model.encode(torch.from_numpy(x))
    np.testing.assert_allclose(dec, ref_dec, atol=ATOL)
    # KL: the raw mean || log_var map; VQ: the nearest codes, beta times the
    # commitment loss and the batch's code perplexity
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref_enc[0]), atol=ATOL)
    np.testing.assert_allclose([float(prior), float(perplexity)],
                               [float(ref_enc[1]), float(ref_enc[2])], rtol=ATOL)
    back = vae_flax_variables(model.state_dict())
    jax.tree.map(np.testing.assert_array_equal, back, variables)


def test_fresh_vq_codebook_draws_from_the_reference_distribution():
    """A fresh codebook's embeddings and EMA sums come from U(+-1/K), as the
    JAX package's and the original's do; its cluster sizes are zero.
    Without a generator everything is zero, ready to be loaded."""
    arch = VAEArch(channels=(8, 16), z_dim=3, bottleneck="vq", codebook_size=1024,
                   codebook_beta=0.25, codebook_gamma=0.99, num_groups=4, init_resolution=16)
    cb = build_vae(arch, torch.float32, "cpu", torch.Generator().manual_seed(0)).codebook
    for t in (cb.embeddings.weight.detach(), cb.ema_w):
        assert t.shape == (1024, 3) and t.dtype == torch.float32
        assert 0 < float(t.abs().max()) <= 1.0 / 1024
    assert not torch.equal(cb.embeddings.weight, cb.ema_w)
    assert not cb.ema_cluster_size.any()
    empty = build_vae(arch, torch.float32, "cpu").codebook
    assert not any(t.any() for t in (empty.embeddings.weight, empty.ema_w, empty.ema_cluster_size))


def _codebook_state(rng, size, dim):
    """A codebook state as training leaves it: spread embeddings, positive
    cluster sizes, EMA sums."""
    return {"embeddings": rng.standard_normal((size, dim)).astype(np.float32),
            "ema_cluster_size": rng.uniform(0.5, 3.0, size).astype(np.float32),
            "ema_w": rng.standard_normal((size, dim)).astype(np.float32)}


def test_codebook_train_mode_and_ema_update_match_flax():
    """The same embeddings, state and fp32 tokens: codes equal; the deferred
    statistics (counts, dw) and the state after one train-mode update
    (cluster sizes, ema_w, embeddings) at rtol 1e-5; the straight-through
    output, beta times the commitment loss, the perplexity and the
    perplexity over the valid rows only at 2e-4; `indices` equal."""
    from image_diffusion_tpu.models.vae import Codebook as JCodebook
    from image_diffusion_torch.models.vae import Codebook

    rng = np.random.default_rng(11)
    state = _codebook_state(rng, 16, 3)
    z = rng.standard_normal((3, 4, 4, 3)).astype(np.float32)
    mask = np.array([True, True, False])
    jcb = JCodebook(size=16, dim=3, beta=0.25, gamma=0.99, dtype=jnp.float32)
    variables = {"codebook": state}
    (ref_q, ref_loss, ref_perp), mut = jcb.apply(variables, z, train=True, mutable=["codebook"])
    _, sown = jcb.apply(variables, z, train=True, defer_ema=True, mutable=["vq_stats"])
    ref_masked = jcb.apply(variables, z, valid_mask=mask)[2]
    ref_idx = np.asarray(jcb.apply(variables, z, method="indices"))

    cb = Codebook(16, 3, 0.99)
    cb.load_state_dict({"embeddings.weight": torch.from_numpy(state["embeddings"]),
                        "ema_cluster_size": torch.from_numpy(state["ema_cluster_size"]),
                        "ema_w": torch.from_numpy(state["ema_w"])})
    tz = torch.from_numpy(z)
    np.testing.assert_array_equal(cb.indices(tz).numpy(), ref_idx)
    stats = cb.empty_stats()
    q, commitment, perp = cb(tz, train=True, ema_stats=stats)
    assert torch.equal(cb.embeddings.weight, torch.from_numpy(state["embeddings"]))  # deferred
    for got, name in zip(stats, ("counts", "dw")):
        np.testing.assert_allclose(got.numpy(), np.asarray(sown["vq_stats"][name]), rtol=1e-5)
    np.testing.assert_allclose(float(perp), float(ref_perp), rtol=ATOL)
    np.testing.assert_allclose(float(cb(tz, valid_mask=torch.from_numpy(mask))[2]),
                               float(ref_masked), rtol=ATOL)
    q2, commitment2, _ = cb(tz, train=True)  # the codes of the state before the update
    for got in (q, q2):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_q), atol=ATOL)
    for got in (commitment, commitment2):
        np.testing.assert_allclose(0.25 * float(got), float(ref_loss), rtol=ATOL)
    new = mut["codebook"]
    for got, name in ((cb.ema_cluster_size, "ema_cluster_size"), (cb.ema_w, "ema_w"),
                      (cb.embeddings.weight, "embeddings")):
        np.testing.assert_allclose(got.numpy(), np.asarray(new[name]), rtol=1e-5)


def test_codebook_statistics_at_crowded_codes_match_flax():
    """A full-width batch's tokens (48 x 32 x 32, dim 3) crowded onto 4 of
    1,024 codes (9,399-20,798 tokens each), as early in training: the
    deferred statistics against flax's, counts equal and dw, JAX's product
    of the one-hot codes with the tokens, at max|diff| / max|dw| 1e-6
    (read 1.1e-7 to 2.2e-7 over 1, 2 and 8 threads; the arrival-order sum
    of `index_add_` read 4.7e-6)."""
    from image_diffusion_tpu.models.vae import Codebook as JCodebook
    from image_diffusion_torch.models.vae import Codebook

    rng = np.random.default_rng(13)
    size, dim = 1024, 3
    emb = rng.uniform(-1 / size, 1 / size, (size, dim)).astype(np.float32)
    emb[:4] = [[1, 1, 1], [1.5, 1, 1], [1, 1.5, 1], [1, 1, 1.5]]
    state = {"embeddings": emb, "ema_cluster_size": np.zeros(size, np.float32), "ema_w": emb}
    z = rng.uniform(0.5, 1.5, (48, 32, 32, dim)).astype(np.float32)
    jcb = JCodebook(size=size, dim=dim, beta=0.25, gamma=0.99, dtype=jnp.float32)
    _, sown = jcb.apply({"codebook": state}, z, train=True, defer_ema=True, mutable=["vq_stats"])
    cb = Codebook(size, dim, 0.99)
    cb.load_state_dict({"embeddings.weight": torch.from_numpy(emb),
                        "ema_cluster_size": torch.from_numpy(state["ema_cluster_size"]),
                        "ema_w": torch.from_numpy(emb)})
    counts, dw = cb.empty_stats()
    cb(torch.from_numpy(z), train=True, ema_stats=(counts, dw))
    ref = {k: np.asarray(v) for k, v in sown["vq_stats"].items()}
    np.testing.assert_array_equal(counts.numpy(), ref["counts"])
    assert counts.numpy()[:4].min() > 9000 and counts.numpy()[4:].sum() == 0
    assert np.abs(dw.numpy() - ref["dw"]).max() <= 1e-6 * np.abs(ref["dw"]).max()


def test_codebook_is_state_not_a_parameter():
    """The codebook is no parameter of the VAE (so no optimizer or count
    sees it), is held in fp32 at any parameter dtype, keeps its state-dict
    keys, and the parameters alone convert to flax params."""
    arch = VAEArch(**VAE_TINY, **VQ)
    for param_dtype in (torch.float32, torch.bfloat16):
        model = build_vae(arch, torch.bfloat16, "cpu", torch.Generator().manual_seed(0),
                          param_dtype=param_dtype)
        assert not [n for n, _ in model.named_parameters() if n.startswith("codebook")]
        assert {n for n, _ in model.named_buffers() if n.startswith("codebook")} == {
            "codebook.embeddings.weight", "codebook.ema_cluster_size", "codebook.ema_w"}
        assert all(b.dtype == torch.float32 for b in model.codebook.buffers())
        assert sum(p.numel() for p in model.parameters()) == sum(
            v.numel() for k, v in model.state_dict().items() if not k.startswith("codebook."))
    variables = vae_flax_variables(dict(model.named_parameters()))
    assert set(variables) == {"params"}


def test_encode_indices_match_flax():
    """encode_indices (VQ) on the same weights and spread embeddings: the
    codes equal; KL refuses."""
    jmodel = JVAE(**VAE_TINY, **VQ, dtype=jnp.float32)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda: jmodel.init({"params": jax.random.key(0)}, x, sample=False))())
    variables["codebook"]["codebook"] = _codebook_state(rng, 32, 3)
    ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, method="encode_indices"))(variables, x))
    model = build_vae(VAEArch(**VAE_TINY, **VQ), torch.float32, "cpu")
    model.load_state_dict(vae_state_dict(variables))
    got = model.encode_indices(torch.from_numpy(x))
    assert got.shape == (2, 16, 16) and len(np.unique(ref)) > 1
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match="VQ"):
        build_vae(VAEArch(**VAE_TINY), torch.float32, "cpu").encode_indices(torch.from_numpy(x))
