"""The port's CLIP (`image_diffusion_torch/models/clip.py`) against the JAX
package's `models/clip.py` on one random state dict in transformers'
`CLIPModel` layout, and against transformers' own eager `CLIPModel`."""

import jax  # noqa: F401  (tests/conftest.py keeps it on the CPU)
import numpy as np
import pytest
import torch

from image_diffusion_tpu.models.clip import CLIPZeroShot as JCLIP
from image_diffusion_torch.models.clip import CLIPZeroShot

# fp32 on both sides through 2 + 2 layers; the two sum in other orders
REL = 1e-4
TINY = dict(vision_width=32, vision_layers=2, vision_hidden=64, vision_heads=2, image_size=32,
            patch_size=8, vocab_size=64, text_width=24, text_layers=2, text_hidden=48,
            text_heads=2, text_positions=16, projection_dim=16)


def random_clip_state(seed, *, vision_width, vision_layers, vision_hidden, image_size,
                      patch_size, vocab_size, text_width, text_layers, text_hidden,
                      text_positions, projection_dim, **_):
    """A random fp32 state dict with the keys and shapes of a transformers
    `CLIPModel` of these widths (no `position_ids` buffers)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, std=0.2):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    state = {"logit_scale": np.asarray(np.log(1 / 0.07), np.float32)}

    def ln(key, width):
        state[key + ".weight"] = 1.0 + normal(width, std=0.1)
        state[key + ".bias"] = normal(width, std=0.1)

    def lin(key, n_in, n_out, bias=True):
        state[key + ".weight"] = normal(n_out, n_in, std=n_in ** -0.5)
        if bias:
            state[key + ".bias"] = normal(n_out, std=0.05)

    def encoder(prefix, width, hidden, layers):
        for i in range(layers):
            base = f"{prefix}.encoder.layers.{i}"
            ln(base + ".layer_norm1", width)
            for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
                lin(f"{base}.self_attn.{p}", width, width)
            ln(base + ".layer_norm2", width)
            lin(base + ".mlp.fc1", width, hidden)
            lin(base + ".mlp.fc2", hidden, width)

    v, t = "vision_model", "text_model"
    state[f"{v}.embeddings.class_embedding"] = normal(vision_width)
    state[f"{v}.embeddings.patch_embedding.weight"] = normal(
        vision_width, 3, patch_size, patch_size, std=(3 * patch_size ** 2) ** -0.5)
    state[f"{v}.embeddings.position_embedding.weight"] = normal(
        (image_size // patch_size) ** 2 + 1, vision_width)
    ln(f"{v}.pre_layrnorm", vision_width)
    encoder(v, vision_width, vision_hidden, vision_layers)
    ln(f"{v}.post_layernorm", vision_width)
    lin("visual_projection", vision_width, projection_dim, bias=False)
    state[f"{t}.embeddings.token_embedding.weight"] = normal(vocab_size, text_width)
    state[f"{t}.embeddings.position_embedding.weight"] = normal(text_positions, text_width)
    encoder(t, text_width, text_hidden, text_layers)
    ln(f"{t}.final_layer_norm", text_width)
    lin("text_projection", text_width, projection_dim, bias=False)
    return state


def random_batch(seed, eos_id, n=3, b=4, L=9, size=32):
    """Pixels (NCHW, the processor's layout) and padded token rows: a start
    token, random ids, EOS, padding.  With eos_id the vocabulary's largest
    id, the legacy argmax pooling finds the same position."""
    rng = np.random.default_rng(seed)
    pixel = rng.normal(0, 1, (b, 3, size, size)).astype(np.float32)
    ids = np.zeros((n, L), np.int64)
    am = np.zeros((n, L), np.int64)
    for i, ln in enumerate(rng.integers(3, L + 1, (n,))):
        ids[i, 0] = 1
        ids[i, 1:ln - 1] = rng.integers(3, 60, (ln - 2,))
        ids[i, ln - 1] = eos_id
        am[i, :ln] = 1
    return pixel, ids, am


def assert_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= REL * np.abs(ref).max(), np.abs(got - ref).max()


@pytest.mark.parametrize("eos_token_id", [63, 2], ids=["first-eos", "legacy-argmax"])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no-mask"])
def test_clip_matches_jax(eos_token_id, layout, masked):
    state = random_clip_state(0, **TINY)
    kw = dict(vision_heads=TINY["vision_heads"], text_heads=TINY["text_heads"],
              patch_size=TINY["patch_size"], eos_token_id=eos_token_id)
    jclip = JCLIP.from_state_dict(state, **kw)
    port = CLIPZeroShot.from_state_dict(state, **kw, device="cpu")
    pixel, ids, am = random_batch(1, eos_id=63)
    if layout == "nhwc":
        pixel = pixel.transpose(0, 2, 3, 1)
    am = am if masked else None

    assert_close(port.encode_images(pixel), jclip.encode_images(pixel))
    assert_close(port.encode_text(ids, am), jclip.encode_text(ids, am))
    logits = port.logits_per_image(pixel, ids, am)
    assert logits.shape == (4, 3) and logits.dtype == torch.float32
    assert_close(logits, jclip.logits_per_image(pixel, ids, am))


def test_clip_pools_where_its_config_says():
    """The first EOS, or (eos_token_id == 2) the largest id: on a row whose
    EOS is not its largest id the two branches pool at different tokens,
    and each matches JAX's."""
    ids = np.array([[1, 5, 40, 7, 60, 0]])
    state = random_clip_state(2, **TINY)
    kw = dict(vision_heads=2, text_heads=2, patch_size=8)
    for eos, at in ((40, 2), (2, 4)):
        port = CLIPZeroShot.from_state_dict(state, **kw, eos_token_id=eos, device="cpu")
        assert port._eot_index(ids).tolist() == [at]
        assert_close(port.encode_text(ids),
                     JCLIP.from_state_dict(state, **kw, eos_token_id=eos).encode_text(ids))


def test_clip_state_dict_keys_must_match():
    state = random_clip_state(0, **TINY)
    state["vision_model.embeddings.position_ids"] = np.arange(17)[None]
    CLIPZeroShot.from_state_dict(state, vision_heads=2, text_heads=2, patch_size=8,
                                 device="cpu")
    del state["text_projection.weight"]
    with pytest.raises(RuntimeError, match="text_projection"):
        CLIPZeroShot.from_state_dict(state, vision_heads=2, text_heads=2, patch_size=8,
                                     device="cpu")


def hf_tiny(eos_token_id):
    from transformers import CLIPConfig, CLIPModel

    cfg = CLIPConfig(
        text_config=dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=16, projection_dim=16,
                         eos_token_id=eos_token_id),
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2, image_size=32, patch_size=8,
                           projection_dim=16),
        projection_dim=16)
    torch.manual_seed(0)
    return CLIPModel(cfg).eval()


@pytest.mark.parametrize("eos_token_id", [63, 2], ids=["first-eos", "legacy-argmax"])
def test_clip_matches_transformers(eos_token_id):
    pytest.importorskip("transformers")
    model = hf_tiny(eos_token_id)
    pixel, ids, am = random_batch(5, eos_id=63)
    with torch.no_grad():
        out = model(pixel_values=torch.from_numpy(pixel), input_ids=torch.from_numpy(ids),
                    attention_mask=torch.from_numpy(am))
    port = CLIPZeroShot.from_torch_model(model, device="cpu")
    assert_close(port.logits_per_image(pixel, ids, am), out.logits_per_image.numpy())
    with torch.no_grad():
        image_features = model.get_image_features(pixel_values=torch.from_numpy(pixel))
    assert_close(port.encode_images(pixel), image_features.numpy())
    # the hand-made state dict has exactly the keys transformers writes
    hf_keys = {k for k in model.state_dict() if not k.endswith("position_ids")}
    tiny = dict(TINY, vision_width=32, text_width=32, text_hidden=64, vision_hidden=64)
    assert set(random_clip_state(0, **tiny)) == hf_keys
