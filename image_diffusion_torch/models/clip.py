"""CLIP zero-shot classifier (ViT + text transformer), the port's
counterpart of the JAX package's `models/clip.py`, which labels the
diffusion dataset (`scripts/prepare_dataset.py --labels-mode clip`).

The module's parameters carry transformers' `CLIPModel` key names
(`vision_model.encoder.layers.0.self_attn.q_proj.weight`, ...,
`logit_scale`), so a `CLIPModel` state dict is its weight file:
`from_state_dict` loads one (the `position_ids` buffers aside, every key
must match), `from_torch_model` a loaded `CLIPModel` with its config.

Semantics are the JAX package's, which are transformers' eager CLIP:
  * vision tower: patch conv (no bias) -> class token -> learned position
    embeddings -> `pre_layrnorm` (transformers' spelling) -> pre-LN
    transformer -> post-LN on the [CLS] token -> visual projection (no bias)
  * text tower: token + position embeddings -> pre-LN transformer under an
    additive causal + padding mask of finfo(float32).min -> final LN ->
    pooled at the first EOS, or at argmax(input_ids) when eos_token_id == 2
    (transformers' legacy branch)
  * logits_per_image = exp(logit_scale) * norm(img) @ norm(txt).T
  * activation quick_gelu (x * sigmoid(1.702 x)) or exact gelu.

Everything is fp32, with TF32 off for the calls (`core.no_tf32`): labels
are an argmax, and TF32 would move near-ties.  Attention is a plain matmul
and softmax: the JAX package's is plain einsums, no Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core import no_tf32, resolve_device

_NEG = float(np.finfo(np.float32).min)  # transformers masks with finfo(dtype).min
_EPS = 1e-5


class _Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            nn.Linear(width, width) for _ in range(4))

    def forward(self, x, mask):
        B, L, D = x.shape
        d = D // self.heads
        q = self.q_proj(x) * d ** -0.5
        q, k, v = (t.view(B, L, self.heads, d).transpose(1, 2)
                   for t in (q, self.k_proj(x), self.v_proj(x)))
        logits = q @ k.transpose(-1, -2)
        if mask is not None:
            logits = logits + mask
        out = torch.softmax(logits, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(B, L, D))


class _MLP(nn.Module):
    def __init__(self, width: int, hidden: int, act: str):
        super().__init__()
        if act not in ("quick_gelu", "gelu"):
            raise ValueError(f"unsupported hidden_act {act!r}")
        self.act = act
        self.fc1, self.fc2 = nn.Linear(width, hidden), nn.Linear(hidden, width)

    def forward(self, x):
        x = self.fc1(x)
        x = x * torch.sigmoid(1.702 * x) if self.act == "quick_gelu" else F.gelu(x)
        return self.fc2(x)


class _Layer(nn.Module):
    def __init__(self, width: int, hidden: int, heads: int, act: str):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(width, eps=_EPS)
        self.self_attn = _Attention(width, heads)
        self.layer_norm2 = nn.LayerNorm(width, eps=_EPS)
        self.mlp = _MLP(width, hidden, act)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, n: int, width: int, hidden: int, heads: int, act: str):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(width, hidden, heads, act) for _ in range(n))

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class _VisionEmbeddings(nn.Module):
    def __init__(self, width: int, patch: int, positions: int):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, width, patch, stride=patch, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.position_embedding = nn.Embedding(positions, width)

    def forward(self, pixel_nchw):
        x = self.patch_embedding(pixel_nchw).flatten(2).transpose(1, 2)  # (B, Hp*Wp, D)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight


class _VisionModel(nn.Module):
    def __init__(self, width, layers, hidden, heads, patch, positions, act):
        super().__init__()
        self.embeddings = _VisionEmbeddings(width, patch, positions)
        self.pre_layrnorm = nn.LayerNorm(width, eps=_EPS)
        self.encoder = _Encoder(layers, width, hidden, heads, act)
        self.post_layernorm = nn.LayerNorm(width, eps=_EPS)

    def forward(self, pixel_nchw):
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixel_nchw)))
        return self.post_layernorm(x[:, 0])


class _TextEmbeddings(nn.Module):
    def __init__(self, vocab: int, width: int, positions: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab, width)
        self.position_embedding = nn.Embedding(positions, width)


class _TextModel(nn.Module):
    def __init__(self, vocab, width, layers, hidden, heads, positions, act):
        super().__init__()
        self.embeddings = _TextEmbeddings(vocab, width, positions)
        self.encoder = _Encoder(layers, width, hidden, heads, act)
        self.final_layer_norm = nn.LayerNorm(width, eps=_EPS)

    def forward(self, input_ids, attention_mask, eot_idx):
        B, L = input_ids.shape
        emb = self.embeddings
        x = emb.token_embedding(input_ids) + emb.position_embedding.weight[:L]
        causal = torch.full((L, L), _NEG, device=x.device).triu(1)
        mask = causal + (1.0 - attention_mask.float())[:, None, None, :] * _NEG
        x = self.final_layer_norm(self.encoder(x, mask))
        return x[torch.arange(B, device=x.device), eot_idx]


def _n_layers(state: Mapping[str, Any], prefix: str) -> int:
    n = 0
    while f"{prefix}.encoder.layers.{n}.layer_norm1.weight" in state:
        n += 1
    return n


class CLIPZeroShot(nn.Module):
    """Frozen CLIP for zero-shot labels.  Construct with `from_state_dict`
    or `from_torch_model`; inputs may be numpy arrays or tensors on any
    device, outputs are fp32 tensors on the model's device."""

    def __init__(self, *, vision_width: int, vision_layers: int, vision_hidden: int,
                 vision_heads: int, patch_size: int, vision_positions: int, vocab_size: int,
                 text_width: int, text_layers: int, text_hidden: int, text_heads: int,
                 text_positions: int, projection_dim: int, hidden_act: str = "quick_gelu",
                 eos_token_id: int = 49407):
        super().__init__()
        self.eos_token_id = eos_token_id
        self.vision_model = _VisionModel(vision_width, vision_layers, vision_hidden,
                                         vision_heads, patch_size, vision_positions, hidden_act)
        self.text_model = _TextModel(vocab_size, text_width, text_layers, text_hidden,
                                     text_heads, text_positions, hidden_act)
        self.visual_projection = nn.Linear(vision_width, projection_dim, bias=False)
        self.text_projection = nn.Linear(text_width, projection_dim, bias=False)
        self.logit_scale = nn.Parameter(torch.empty(()))

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def _eot_index(self, ids: np.ndarray) -> np.ndarray:
        """transformers' pooling index, on the host: legacy models
        (eos_token_id == 2) pool at argmax(input_ids), since EOS is the
        largest id of the CLIP vocabulary; others at the first EOS."""
        if self.eos_token_id == 2:
            return ids.argmax(-1)
        return (ids == self.eos_token_id).argmax(-1)

    @torch.no_grad()
    def encode_images(self, pixel_values) -> torch.Tensor:
        """Processor output, (B, 3, H, W) NCHW or (B, H, W, 3) NHWC ->
        (B, projection_dim) unnormalised embeddings."""
        pv = torch.as_tensor(pixel_values).to(self.device, torch.float32)
        if not (pv.shape[1] == 3 and pv.shape[-1] != 3):
            pv = pv.permute(0, 3, 1, 2)
        with no_tf32():
            return self.visual_projection(self.vision_model(pv))

    @torch.no_grad()
    def encode_text(self, input_ids, attention_mask=None) -> torch.Tensor:
        """(n, L) token ids (and their attention mask) -> (n, projection_dim)
        unnormalised embeddings."""
        ids = np.asarray(torch.as_tensor(input_ids).cpu())
        am = np.ones_like(ids) if attention_mask is None else np.asarray(
            torch.as_tensor(attention_mask).cpu())
        dev = self.device
        with no_tf32():
            pooled = self.text_model(torch.as_tensor(ids, device=dev, dtype=torch.int64),
                                     torch.as_tensor(am, device=dev),
                                     torch.as_tensor(self._eot_index(ids), device=dev))
            return self.text_projection(pooled)

    @torch.no_grad()
    def logits_per_image(self, pixel_values, input_ids, attention_mask=None) -> torch.Tensor:
        img = self.encode_images(pixel_values)
        txt = self.encode_text(input_ids, attention_mask)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        with no_tf32():
            return self.logit_scale.exp() * img @ txt.T

    # ---- import ----

    @classmethod
    def from_torch_model(cls, model: Any, device="cuda") -> "CLIPZeroShot":
        """A transformers `CLIPModel`'s weights and config, on `device`."""
        vc, tc = model.config.vision_config, model.config.text_config
        return cls.from_state_dict(model.state_dict(), vision_heads=vc.num_attention_heads,
                                   text_heads=tc.num_attention_heads, patch_size=vc.patch_size,
                                   hidden_act=vc.hidden_act, eos_token_id=tc.eos_token_id,
                                   device=device)

    @classmethod
    def from_state_dict(cls, state: Mapping[str, Any], *, vision_heads: int, text_heads: int,
                        patch_size: int, hidden_act: str = "quick_gelu",
                        eos_token_id: int = 49407, device="cuda") -> "CLIPZeroShot":
        """A state dict in transformers' `CLIPModel` layout (numpy arrays or
        tensors) -> the model in fp32 on `device`, in eval mode.  Widths,
        depths and vocabulary come from the shapes."""
        state = {k: torch.as_tensor(v.detach() if torch.is_tensor(v) else np.asarray(v))
                 .to("cpu", torch.float32, copy=True).contiguous()
                 for k, v in state.items() if not k.endswith("position_ids")}
        v, t = "vision_model", "text_model"
        with torch.device("meta"):
            model = cls(
                vision_width=state[f"{v}.embeddings.class_embedding"].shape[0],
                vision_layers=_n_layers(state, v),
                vision_hidden=state[f"{v}.encoder.layers.0.mlp.fc1.weight"].shape[0],
                vision_heads=vision_heads, patch_size=patch_size,
                vision_positions=state[f"{v}.embeddings.position_embedding.weight"].shape[0],
                vocab_size=state[f"{t}.embeddings.token_embedding.weight"].shape[0],
                text_width=state[f"{t}.embeddings.token_embedding.weight"].shape[1],
                text_layers=_n_layers(state, t),
                text_hidden=state[f"{t}.encoder.layers.0.mlp.fc1.weight"].shape[0],
                text_heads=text_heads,
                text_positions=state[f"{t}.embeddings.position_embedding.weight"].shape[0],
                projection_dim=state["visual_projection.weight"].shape[0],
                hidden_act=hidden_act, eos_token_id=eos_token_id)
        model.load_state_dict(state, assign=True)
        return model.to(resolve_device(device)).eval().requires_grad_(False)
