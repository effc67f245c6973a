"""Plain fp32 PyTorch statement of DiT-XL/2 sampled through the
latent-diffusion KL-f8 decoder, as facebookresearch/DiT states it.

  * `dit`: the DiT forward of `models.py` (Peebles & Xie, arXiv:2212.09748)
    over a dict of tensors keyed by DiT's state-dict names, equation by
    equation:
      - x_embedder: a p x p stride-p conv, flattened to tokens, plus the
        fixed 2-D sin-cos `pos_embed` (`get_2d_sincos_pos_embed`);
      - t_embedder: freqs = exp(-ln(10000) i / 128), i < 128; cat[cos(t
        freqs), sin(t freqs)]; Linear-SiLU-Linear;
      - y_embedder: the embedding table's row of the class id, row
        num_classes being the null class (the guidance's unconditional
        half);
      - c = t + y; each block: shift/scale/gate x 2 = Linear(SiLU(c))
        chunked in six; x += gate_msa * attn(LN(x) (1 + scale_msa) +
        shift_msa); x += gate_mlp * mlp(LN(x) (1 + scale_mlp) + shift_mlp),
        LN without affine at eps 1e-6; attention: qkv Linear with bias,
        (3, heads, d) split of its output, softmax(q k^T / sqrt(d)) v,
        proj; mlp: fc1, GELU (tanh approximation), fc2;
      - final layer: shift, scale = Linear(SiLU(c)), LN, modulate, Linear
        to p * p * out channels, unpatchify (`nhwpqc -> nchpwq`).
  * `ldm_decode`: `AutoencoderKL.decode` of CompVis latent-diffusion
    (`ldm/modules/diffusionmodules/model.py:Decoder`, kl-f8 config:
    post_quant_conv 1x1, conv_in, mid ResnetBlock / AttnBlock /
    ResnetBlock, per level from the widest num_res_blocks + 1
    ResnetBlocks and a nearest-2x upsample with a conv except after the
    last, norm_out, swish, conv_out; GroupNorm(32, eps 1e-6); the
    ResnetBlock without its time embedding: norm1, swish, conv1, norm2,
    swish, conv2, plus x through a 1x1 nin_shortcut on a channel change;
    AttnBlock: norm, 1x1 q, k, v, softmax(q k^T / sqrt(c)) over the H*W
    tokens, 1x1 proj_out, plus x).
  * `alpha_bars`: DiT's "linear" schedule, linear in beta:
    np.linspace(1e-4, 0.02, 1000), cumulative product in float64.
  * `ddim_update` / `ddim_sample`: the guided DDIM step at eta 0 from the
    eps half of the learned-sigma output, x0 not clipped (sample.py's
    clip_denoised=False), the last step to x0.

Departures from the published code, each as the benchmark's configuration
states it (`configs/dit-xl2-256.json` `assumed`):
  * weights are drawn from the seed with PyTorch's default statistics for
    every layer (U(+-1/sqrt(fan_in)) for linear and conv weights and biases,
    N(0, 1) for the label table), the adaLN modulation and final layers
    included: DiT's adaLN-Zero initialization zeroes every gate and the
    output, which would make the model the identity at set-up;
  * guidance combines all 4 eps channels (`forward_with_cfg` guides the
    first 3 only "for exact reproducibility");
  * the 50 DDIM timesteps are linspace(0, 999, 50) rounded, not DiT's
    `space_timesteps` stride of 20.

Each function takes `q`, applied to both operands of every convolution,
linear layer and attention product (`lowp.py`, the control), as `nets.py`
does.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from . import nets
from .nets import Leaf, Q, ident

LN_EPS = 1e-6
GN_EPS = 1e-6
FREQUENCIES = 256


# ------------------------------------------------------------- configuration


def dit_arch(config: dict) -> dict:
    keys = ("input_size", "patch_size", "in_channels", "hidden_size", "depth", "num_heads",
            "mlp_ratio", "class_dropout_prob", "num_classes", "learn_sigma")
    return {k: config[k] for k in keys}


def out_channels(arch: dict) -> int:
    return arch["in_channels"] * (2 if arch["learn_sigma"] else 1)


def tokens(arch: dict) -> int:
    return (arch["input_size"] // arch["patch_size"]) ** 2


def latent_res(vae: dict) -> int:
    return vae["init_resolution"] // 2 ** (len(vae["channels"]) - 1)


# ------------------------------------------------------------- weights


def dit_leaves(arch: dict) -> list[Leaf]:
    """Every drawn tensor of the DiT (`pos_embed` is computed by
    `pos_embed`)."""
    D, p, C = arch["hidden_size"], arch["patch_size"], arch["in_channels"]
    hidden = int(D * arch["mlp_ratio"])
    out = nets._conv("x_embedder.proj", C, D, p)
    out += nets._linear("t_embedder.mlp.0", FREQUENCIES, D)
    out += nets._linear("t_embedder.mlp.2", D, D)
    out.append(Leaf("y_embedder.embedding_table.weight", (arch["num_classes"] + 1, D),
                    ("normal", 0.0, 1.0)))
    for i in range(arch["depth"]):
        b = f"blocks.{i}"
        out += nets._linear(f"{b}.attn.qkv", D, 3 * D)
        out += nets._linear(f"{b}.attn.proj", D, D)
        out += nets._linear(f"{b}.mlp.fc1", D, hidden)
        out += nets._linear(f"{b}.mlp.fc2", hidden, D)
        out += nets._linear(f"{b}.adaLN_modulation.1", D, 6 * D)
    out += nets._linear("final_layer.linear", D, p * p * out_channels(arch))
    out += nets._linear("final_layer.adaLN_modulation.1", D, 2 * D)
    return out


def pos_embed(arch: dict) -> torch.Tensor:
    """`get_2d_sincos_pos_embed(hidden, grid)` as (1, grid^2, hidden)
    fp32: token i * grid + j, the first half of the channels from column
    j, the second from row i, each [sin, cos] of pos * omega, omega =
    1 / 10000^(k / (hidden / 4))."""
    D, grid = arch["hidden_size"], arch["input_size"] // arch["patch_size"]

    def one_d(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    cols, rows = np.meshgrid(np.arange(grid, dtype=np.float32), np.arange(grid, dtype=np.float32))
    emb = np.concatenate([one_d(D // 2, cols), one_d(D // 2, rows)], axis=1)
    return torch.from_numpy(emb.astype(np.float32))[None]


def dit_weights(arch: dict, seed: int, device, dtype: torch.dtype = torch.float32) -> dict:
    """The DiT's state dict drawn from `seed` on `device` (`nets.make_weights`)
    with its `pos_embed`, all in `dtype`."""
    P = nets.make_weights(dit_leaves(arch), seed, device, dtype)
    P["pos_embed"] = pos_embed(arch).to(device, dtype)
    return P


def _ldm_res(name: str, cin: int, cout: int) -> list[Leaf]:
    out = nets._gn(f"{name}.norm1", cin) + nets._conv(f"{name}.conv1", cin, cout)
    out += nets._gn(f"{name}.norm2", cout) + nets._conv(f"{name}.conv2", cout, cout)
    return out + (nets._conv(f"{name}.nin_shortcut", cin, cout, 1) if cin != cout else [])


def _ldm_levels(vae: dict) -> list[tuple[int, list[tuple[int, int]]]]:
    """(level, [(in, out) of each ResnetBlock]) from the widest level down."""
    ch, n = vae["channels"], vae["dec_num_res_blocks"] + 1
    cur, out = ch[-1], []
    for i in reversed(range(len(ch))):
        blocks = []
        for _ in range(n):
            blocks.append((cur, ch[i]))
            cur = ch[i]
        out.append((i, blocks))
    return out


def ldm_decoder_leaves(vae: dict) -> list[Leaf]:
    z, top = vae["z_dim"], vae["channels"][-1]
    out = nets._conv("post_quant_conv", z, z, 1) + nets._conv("decoder.conv_in", z, top)
    out += _ldm_res("decoder.mid.block_1", top, top)
    out += nets._gn("decoder.mid.attn_1.norm", top)
    for proj in ("q", "k", "v", "proj_out"):
        out += nets._conv(f"decoder.mid.attn_1.{proj}", top, top, 1)
    out += _ldm_res("decoder.mid.block_2", top, top)
    for i, blocks in _ldm_levels(vae):
        for j, (cin, cout) in enumerate(blocks):
            out += _ldm_res(f"decoder.up.{i}.block.{j}", cin, cout)
        if i > 0:
            out += nets._conv(f"decoder.up.{i}.upsample.conv", blocks[-1][1], blocks[-1][1])
    bottom = vae["channels"][0]
    return out + nets._gn("decoder.norm_out", bottom) + nets._conv("decoder.conv_out", bottom,
                                                                   vae["in_channels"])


# ------------------------------------------------------------- the DiT


def modulate(x, shift, scale):
    return F.layer_norm(x, (x.shape[-1],), eps=LN_EPS) * (1 + scale[:, None]) + shift[:, None]


def timestep_embedding(P, t, q: Q):
    half = FREQUENCIES // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return nets.linear(P, "t_embedder.mlp.2",
                       F.silu(nets.linear(P, "t_embedder.mlp.0", emb, q)), q)


def attention(P, name: str, x, heads: int, q: Q, sites: list | None = None):
    B, N, C = x.shape
    d = C // heads
    if sites is not None:
        sites.append((B, N, C, heads))
    qkv = nets.linear(P, f"{name}.qkv", x, q).reshape(B, N, 3, heads, d).permute(2, 0, 3, 1, 4)
    scores = torch.matmul(q(qkv[0]), q(qkv[1]).transpose(-1, -2)) * d ** -0.5
    out = torch.matmul(q(torch.softmax(scores, dim=-1)), q(qkv[2]))
    return nets.linear(P, f"{name}.proj", out.transpose(1, 2).reshape(B, N, C), q)


def block(P, name: str, x, c, heads: int, q: Q, sites=None):
    mod = nets.linear(P, f"{name}.adaLN_modulation.1", F.silu(c), q)
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=1)
    x = x + gate_msa[:, None] * attention(P, f"{name}.attn", modulate(x, shift_msa, scale_msa),
                                          heads, q, sites)
    h = modulate(x, shift_mlp, scale_mlp)
    h = nets.linear(P, f"{name}.mlp.fc2",
                    F.gelu(nets.linear(P, f"{name}.mlp.fc1", h, q), approximate="tanh"), q)
    return x + gate_mlp[:, None] * h


def dit(P, arch: dict, x, t, labels, q: Q = ident, sites: list | None = None):
    """NHWC latents (B, H, W, C), timesteps (B,), class ids (B,), the null
    class being num_classes -> DiT's output (B, H, W, out channels), NHWC
    (eps, then the variance interpolation)."""
    B = x.shape[0]
    p, out_c = arch["patch_size"], out_channels(arch)
    g = arch["input_size"] // p
    h = nets.conv(P, "x_embedder.proj", x.permute(0, 3, 1, 2), q, stride=p, padding=0)
    h = h.flatten(2).transpose(1, 2) + P["pos_embed"]
    c = timestep_embedding(P, t, q) + P["y_embedder.embedding_table.weight"][labels]
    for i in range(arch["depth"]):
        h = block(P, f"blocks.{i}", h, c, arch["num_heads"], q, sites)
    shift, scale = nets.linear(P, "final_layer.adaLN_modulation.1", F.silu(c), q).chunk(2, dim=1)
    h = nets.linear(P, "final_layer.linear", modulate(h, shift, scale), q)
    imgs = torch.einsum("nhwpqc->nchpwq", h.reshape(B, g, g, p, p, out_c))
    return imgs.reshape(B, out_c, g * p, g * p).permute(0, 2, 3, 1)


# ------------------------------------------------------------- the decoder


def group_norm(P, name: str, x, groups: int):
    return F.group_norm(x, groups, P[f"{name}.weight"], P[f"{name}.bias"], GN_EPS)


def resnet_block(P, name: str, x, groups: int, q: Q):
    h = nets.conv(P, f"{name}.conv1", F.silu(group_norm(P, f"{name}.norm1", x, groups)), q)
    h = nets.conv(P, f"{name}.conv2", F.silu(group_norm(P, f"{name}.norm2", h, groups)), q)
    skip = nets.conv(P, f"{name}.nin_shortcut", x, q) if f"{name}.nin_shortcut.weight" in P else x
    return skip + h


def attn_block(P, name: str, x, groups: int, q: Q, sites=None):
    B, C, H, W = x.shape
    h = group_norm(P, f"{name}.norm", x, groups)
    qh, kh, vh = (nets.conv(P, f"{name}.{p}", h, q).reshape(B, C, H * W) for p in "qkv")
    if sites is not None:
        sites.append((B, H * W, C, 1))
    w = torch.softmax(torch.bmm(q(qh.permute(0, 2, 1)), q(kh)) * C ** -0.5, dim=2)
    out = torch.bmm(q(vh), q(w.permute(0, 2, 1))).reshape(B, C, H, W)
    return x + nets.conv(P, f"{name}.proj_out", out, q)


def ldm_decode(P, vae: dict, z, q: Q = ident, sites: list | None = None):
    """NHWC latents, already divided by the latent scale -> NHWC images."""
    G = vae["num_groups"]
    h = nets.conv(P, "decoder.conv_in", nets.conv(P, "post_quant_conv", z.permute(0, 3, 1, 2), q),
                  q)
    h = resnet_block(P, "decoder.mid.block_1", h, G, q)
    h = attn_block(P, "decoder.mid.attn_1", h, G, q, sites)
    h = resnet_block(P, "decoder.mid.block_2", h, G, q)
    for i, blocks in _ldm_levels(vae):
        for j in range(len(blocks)):
            h = resnet_block(P, f"decoder.up.{i}.block.{j}", h, G, q)
        if i > 0:
            h = nets.upsample(P, f"decoder.up.{i}.upsample.conv", h, q)
    h = F.silu(group_norm(P, "decoder.norm_out", h, G))
    return nets.conv(P, "decoder.conv_out", h, q).permute(0, 2, 3, 1)


# ------------------------------------------------------------- the sampler


def alpha_bars(cfg: dict) -> np.ndarray:
    """alpha-bar_t of DiT's linear-in-beta schedule, float64 kept in fp32."""
    if cfg["noise_type"] != "beta-linear":
        raise ValueError(f"the reference states the linear-in-beta schedule, not "
                         f"{cfg['noise_type']}")
    betas = np.linspace(cfg["beta_start"], cfg["beta_end"], cfg["num_steps"], dtype=np.float64)
    return np.cumprod(1.0 - betas).astype(np.float32)


@torch.no_grad()
def ddim_update(Pd, arch: dict, acp: np.ndarray, x, t, t_prev, labels, scales, q: Q = ident):
    """One guided DDIM step (eta 0) of every row: x at timesteps `t` (B,)
    to `t_prev` (B,), -1 meaning the last step to x0.  One call on [x, x]
    with the class ids, then the null class; eps = eps_u + s (eps_c -
    eps_u) over the eps half's channels; x0 not clipped."""
    B, C = x.shape[0], arch["in_channels"]
    null = torch.full_like(labels, arch["num_classes"])
    e = dit(Pd, arch, torch.cat([x, x]), torch.cat([t, t]), torch.cat([labels, null]), q)[..., :C]
    eps = e[B:] + scales.reshape(B, 1, 1, 1).float() * (e[:B] - e[B:])
    table = torch.as_tensor(acp, device=x.device)
    a_t = table[t].reshape(B, 1, 1, 1)
    a_p = torch.where(t_prev >= 0, table[t_prev.clamp(min=0)], 1.0).reshape(B, 1, 1, 1)
    x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_p) * x0 + torch.sqrt(torch.clamp(1.0 - a_p, min=0.0)) * eps


def ddim_timesteps(T: int, n: int) -> list[int]:
    """linspace(0, T - 1, n) rounded, descending."""
    return np.linspace(0, T - 1, n).round().astype(np.int64)[::-1].tolist()


@torch.no_grad()
def ddim_sample(Pd, arch: dict, Pv, vae: dict, sched: dict, x, labels, scales, steps: int,
                q: Q = ident) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Initial latents (B, h, w, z), class ids (B,), guidance scales (B,)
    -> (images, the latents before every step and the final one), the
    decode taking the final latent over the latent scale."""
    acp = alpha_bars(sched)
    timesteps = ddim_timesteps(sched["num_steps"], steps)
    states = [x]
    for t, t_prev in zip(timesteps, timesteps[1:] + [-1]):
        tv = torch.full((x.shape[0],), t, device=x.device)
        x = ddim_update(Pd, arch, acp, x, tv, torch.full_like(tv, t_prev), labels, scales, q)
        states.append(x)
    return ldm_decode(Pv, vae, x / vae["latent_scale"], q), states


# ------------------------------------------------------------- work


def flop_counts(config: dict) -> dict[str, int]:
    """dit_forward_per_row and vae_decode_per_image: matrix products and
    convolutions of the reference on the meta device, two operations a
    multiply-add (`torch.utils.flop_counter`, as `flopcount.py` counts)."""
    meta = torch.device("meta")
    arch, vae = dit_arch(config), config["vae"]
    P = {l.name: torch.empty(l.shape, device=meta) for l in dit_leaves(arch)}
    P["pos_embed"] = torch.empty(1, tokens(arch), arch["hidden_size"], device=meta)
    Pv = {l.name: torch.empty(l.shape, device=meta) for l in ldm_decoder_leaves(vae)}
    r, z = arch["input_size"], arch["in_channels"]
    ids = torch.zeros(1, dtype=torch.long, device=meta)

    def count(fn) -> int:
        with FlopCounterMode(display=False) as counter:
            fn()
        return counter.get_total_flops()

    return {"dit_forward_per_row": count(lambda: dit(P, arch, torch.empty(1, r, r, z, device=meta),
                                                     ids, ids)),
            "vae_decode_per_image": count(lambda: ldm_decode(
                Pv, vae, torch.empty(1, latent_res(vae), latent_res(vae), vae["z_dim"],
                                     device=meta)))}
