"""Plain fp32 PyTorch statement of the models the benchmark measures.

The class-conditional UNet denoiser and the KL autoencoder of
jklimmek/image-diffusion (`configs/diff-kl-lin-32x32.yaml`,
`configs/vae-kl-32x32.yaml`), the PatchGAN discriminator and the LPIPS
distance on VGG16 widths, written as functions over a dict of tensors keyed
by the original implementation's state-dict names.  The system under test
loads the same dict, so both sides run on one set of weights.

Each function takes `q`, applied to both operands of every convolution,
linear layer and attention product: the identity for the reference, a
lower-precision rounding for the benchmark's control (`lowp.py`).
Everything else (normalizations, softmax, losses, the sampler) runs in the
dtype of its inputs, fp32 here.

The equations follow the published models:
  * GroupNorm, eps 1e-5; BatchNorm with the batch's biased variance;
  * self-attention over the H*W tokens with a GroupNorm pre-norm, separate
    q/k/v projections, heads as contiguous channel bands, softmax of
    q k^T / sqrt(d), residual add;
  * Downsample: 3x3 stride-2 conv without padding, then a (0, 1, 0, 1) pad;
    Upsample: nearest 2x, then a 3x3 conv;
  * time embedding: t / 10000^(i / half), [sin, cos], Linear-SiLU-Linear;
    the class embedding (times the condition mask) is added to it;
  * UNet stage: per layer GN-SiLU-conv, plus the time projection, GN-SiLU-
    conv, plus a 1x1 conv of the layer's input, then self-attention; the
    skip tensor is concatenated after x before the first layer.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

Q = Callable[[torch.Tensor], torch.Tensor]


def ident(t: torch.Tensor) -> torch.Tensor:
    return t


class Leaf(NamedTuple):
    """One tensor of a model: state-dict name, shape, how it is drawn
    (`("uniform", bound)`, `("normal", mean, std)`, `("abs_normal", std)`,
    `("const", value)`, `("sinusoid", dim)`) and whether an optimizer
    trains it."""

    name: str
    shape: tuple[int, ...]
    init: tuple
    trainable: bool = True


# ------------------------------------------------------------- weights


def unet_arch(config: dict) -> dict:
    """The UNet's architecture keys of a configuration file."""
    keys = ("z_dim", "channels", "mid_channels", "time_dim", "num_res_layers", "num_heads",
            "num_groups", "num_classes")
    return {k: config[k] for k in keys}


def schedule(config: dict) -> dict:
    return {k: config[k] for k in ("num_steps", "beta_start", "beta_end", "noise_type")}


def latent_res(vae: dict) -> int:
    return vae["init_resolution"] // 2 ** (len(vae["channels"]) - 1)



def _conv(name: str, cin: int, cout: int, k: int = 3, bias: bool = True) -> list[Leaf]:
    bound = 1.0 / math.sqrt(cin * k * k)
    out = [Leaf(f"{name}.weight", (cout, cin, k, k), ("uniform", bound))]
    return out + [Leaf(f"{name}.bias", (cout,), ("uniform", bound))] if bias else out


def _linear(name: str, cin: int, cout: int) -> list[Leaf]:
    bound = 1.0 / math.sqrt(cin)
    return [Leaf(f"{name}.weight", (cout, cin), ("uniform", bound)),
            Leaf(f"{name}.bias", (cout,), ("uniform", bound))]


def _gn(name: str, c: int) -> list[Leaf]:
    return [Leaf(f"{name}.weight", (c,), ("const", 1.0)),
            Leaf(f"{name}.bias", (c,), ("const", 0.0))]


def _attn(name: str, c: int) -> list[Leaf]:
    out = _gn(f"{name}.groupnorm", c)
    for proj in ("to_q", "to_k", "to_v", "out_proj"):
        out += _linear(f"{name}.{proj}", c, c)
    return out


def _stage_blocks(arch: dict) -> list[tuple[str, int, int, int]]:
    """The UNet's stages as (prefix, in channels, out channels, latent
    downsampling factor), in forward order; an up stage's input includes
    its skip."""
    ch, mid = arch["channels"], arch["mid_channels"]
    out, cur, skips, f = [], ch[0], [], 1
    for i, c in enumerate(ch[1:]):
        out.append((f"down_blocks.{i}", cur, c, f))
        cur, f = c, f * 2
        skips.append(c)
    for i, c in enumerate(mid[1:]):
        out.append((f"mid_blocks.{i}", cur, c, f))
        cur = c
    for i, c in enumerate(ch[::-1][1:]):
        f //= 2
        out.append((f"ups.{i}", cur + skips.pop(), c, f))
        cur = c
    return out


def unet_leaves(arch: dict) -> list[Leaf]:
    td, L = arch["time_dim"], arch["num_res_layers"]
    ch = arch["channels"]
    out = [Leaf("class_embedding.weight", (arch["num_classes"], td), ("normal", 0.0, 1.0)),
           Leaf("time_embedding.factor", (td // 2,), ("sinusoid", td), False)]
    out += _linear("time_embedding.embeddings.0", td, 4 * td)
    out += _linear("time_embedding.embeddings.2", 4 * td, td)
    out += _conv("in_conv", arch["z_dim"], ch[0])
    cur = ch[0]
    for prefix, cin, cout, _ in _stage_blocks(arch):
        kind, i = prefix.split(".")
        if kind == "ups":
            out += _conv(f"upsamples.{i}.conv", cur, cur)
        ins = [cin] + [cout] * (L - 1)
        for j, c in enumerate(ins):
            p = f"{prefix}.{{}}.{j}"
            out += _gn(p.format("first_halfs") + ".layers.0", c)
            out += _conv(p.format("first_halfs") + ".layers.2", c, cout)
            out += _linear(p.format("time_projs") + ".1", td, cout)
            out += _gn(p.format("second_halfs") + ".layers.0", cout)
            out += _conv(p.format("second_halfs") + ".layers.2", cout, cout)
            out += _conv(p.format("residuals"), c, cout, 1)
            out += _attn(p.format("self_attns"), cout)
        if kind == "down_blocks":
            out += _conv(f"downsamples.{i}.down", cout, cout)
        cur = cout
    out += _gn("out_conv.0", cur)
    out += _conv("out_conv.2", cur, arch["z_dim"])
    return out


def vae_layers(arch: dict, part: str) -> list[tuple]:
    """The encoder's ("down") or decoder's ("up") trunk as the original's
    `nn.Sequential` indexes it: (kind, index, in channels, out channels)."""
    g_in, z = arch["in_channels"], arch["z_dim"]
    ch = arch["channels"] if part == "down" else arch["channels"][::-1]
    n = arch["enc_num_res_blocks" if part == "down" else "dec_num_res_blocks"]
    attn_res = arch.get("attn_resolutions") or []
    layers: list[tuple] = []

    def add(kind, cin, cout):
        layers.append((kind, len(layers), cin, cout))

    def stage(cur, cout):
        for _ in range(n):
            add("res", cur, cout)
            cur = cout
        return cur

    if part == "down":
        add("conv", g_in, ch[0])
        cur, res = ch[0], arch["init_resolution"]
        for c in ch[1:]:
            cur = stage(cur, c)
            if res in attn_res:
                add("attn", cur, cur)
            add("down", cur, cur)
            res //= 2
        cur = stage(cur, ch[-1])
        add("attn", cur, cur)
        cur = stage(cur, ch[-1])
        add("gn", cur, cur)
        add("silu", cur, cur)
        add("conv", cur, 2 * z)
        add("conv1", 2 * z, 2 * z)
    else:
        add("conv1", z, z)
        add("conv", z, ch[0])
        cur = stage(ch[0], ch[0])
        add("attn", cur, cur)
        cur = stage(cur, ch[0])
        res = arch["init_resolution"] // 2 ** (len(ch) - 1)
        for c in ch[1:]:
            cur = stage(cur, c)
            if res in attn_res:
                add("attn", cur, cur)
            add("up", cur, cur)
            res *= 2
        cur = stage(cur, ch[-1])
        add("gn", cur, cur)
        add("silu", cur, cur)
        add("conv", cur, g_in)
    return layers


def vae_leaves(arch: dict) -> list[Leaf]:
    out: list[Leaf] = []
    for part, trunk in (("down", "encoder"), ("up", "decoder")):
        for kind, i, cin, cout in vae_layers(arch, part):
            name = f"{trunk}.{part}.{i}"
            if kind == "conv":
                out += _conv(name, cin, cout)
            elif kind == "conv1":
                out += _conv(name, cin, cout, 1)
            elif kind == "gn":
                out += _gn(name, cin)
            elif kind == "attn":
                out += _attn(name, cin)
            elif kind == "down":
                out += _conv(f"{name}.down", cin, cin)
            elif kind == "up":
                out += _conv(f"{name}.conv", cin, cin)
            elif kind == "res":
                out += _gn(f"{name}.branch.0", cin) + _conv(f"{name}.branch.2", cin, cout)
                out += _gn(f"{name}.branch.3", cout) + _conv(f"{name}.branch.5", cout, cout)
                if cin != cout:
                    out += _conv(f"{name}.residual_wrapper", cin, cout, 1)
    return out


def disc_leaves(channels: list[int], in_channels: int = 3) -> list[Leaf]:
    dims = [in_channels, *channels, 1]
    n = len(dims) - 1
    out = []
    for i in range(n):
        out.append(Leaf(f"convs.{i}.weight", (dims[i + 1], dims[i], 4, 4), ("normal", 0.0, 0.02)))
        if i in (0, n - 1):
            out.append(Leaf(f"convs.{i}.bias", (dims[i + 1],), ("const", 0.0)))
    for i in range(1, n - 1):
        c = dims[i + 1]
        out += [Leaf(f"norms.{i}.weight", (c,), ("normal", 1.0, 0.02)),
                Leaf(f"norms.{i}.bias", (c,), ("const", 0.0)),
                Leaf(f"norms.{i}.running_mean", (c,), ("const", 0.0), False),
                Leaf(f"norms.{i}.running_var", (c,), ("const", 1.0), False)]
    return out


VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


def lpips_leaves() -> list[Leaf]:
    """13 VGG16 convs (He-normal weights, N(0, 0.05) biases) and the 5
    per-channel "lin" weights |N(0, 0.1)|: random weights of the shapes
    the published LPIPS holds; none is trained."""
    out, cin, i = [], 3, 0
    for cout, n in VGG16_STAGES:
        for _ in range(n):
            out += [Leaf(f"conv.{i}.weight", (cout, cin, 3, 3),
                         ("normal", 0.0, math.sqrt(2.0 / (cin * 9))), False),
                    Leaf(f"conv.{i}.bias", (cout,), ("normal", 0.0, 0.05), False)]
            cin, i = cout, i + 1
    for k, (c, _) in enumerate(VGG16_STAGES):
        out.append(Leaf(f"lin.{k}", (c,), ("abs_normal", 0.1), False))
    return out


def make_weights(leaves: list[Leaf], seed: int, device, dtype: torch.dtype = torch.float32
                 ) -> dict[str, torch.Tensor]:
    """Every leaf drawn from `seed` by one generator on `device`, in two
    large draws (uniform, then normal) cut into the leaves, then cast to
    `dtype` (buffers and constants too).  The same seed on the same device
    gives the same tensors."""
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**64)
    n_u = sum(math.prod(l.shape) for l in leaves if l.init[0] == "uniform")
    n_n = sum(math.prod(l.shape) for l in leaves if l.init[0] in ("normal", "abs_normal"))
    uni = torch.rand(n_u, generator=g, device=device).mul_(2.0).sub_(1.0)
    nor = torch.randn(n_n, generator=g, device=device)
    out, iu, i_n = {}, 0, 0
    for leaf in leaves:
        n, kind = math.prod(leaf.shape), leaf.init[0]
        if kind == "uniform":
            t = uni[iu:iu + n] * leaf.init[1]
            iu += n
        elif kind in ("normal", "abs_normal"):
            t = nor[i_n:i_n + n]
            i_n += n
            t = t.abs() * leaf.init[1] if kind == "abs_normal" else t * leaf.init[2] + leaf.init[1]
        elif kind == "const":
            t = torch.full((n,), float(leaf.init[1]), device=device)
        elif kind == "sinusoid":
            half = leaf.init[1] // 2
            t = 10000.0 ** (torch.arange(half, dtype=torch.float32, device=device) / half)
        else:
            raise ValueError(f"unknown init {leaf.init!r} of {leaf.name}")
        out[leaf.name] = t.reshape(leaf.shape).to(dtype)
    return out


# ------------------------------------------------------------- layers


def conv(P, name: str, x, q: Q, stride: int = 1, padding: int | None = None):
    w = P[f"{name}.weight"]
    pad = w.shape[-1] // 2 if padding is None else padding
    return F.conv2d(q(x), q(w), P.get(f"{name}.bias"), stride=stride, padding=pad)


def linear(P, name: str, x, q: Q):
    return F.linear(q(x), q(P[f"{name}.weight"]), P[f"{name}.bias"])


def group_norm(P, name: str, x, groups: int):
    return F.group_norm(x, groups, P[f"{name}.weight"], P[f"{name}.bias"], 1e-5)


def attention(P, name: str, x, heads: int, groups: int, q: Q, sites: list | None = None):
    """Self-attention over the H*W tokens of NCHW `x`, residual add inside.
    `sites`, when given, collects (B, N, C, heads) of every call."""
    B, C, H, W = x.shape
    tok = group_norm(P, f"{name}.groupnorm", x, groups).permute(0, 2, 3, 1).reshape(B, H * W, C)
    d = C // heads
    if sites is not None:
        sites.append((B, H * W, C, heads))
    qh, kh, vh = (linear(P, f"{name}.{p}", tok, q).reshape(B, H * W, heads, d).transpose(1, 2)
                  for p in ("to_q", "to_k", "to_v"))
    scores = torch.matmul(q(qh), q(kh).transpose(-1, -2)) / math.sqrt(d)
    out = torch.matmul(q(torch.softmax(scores, dim=-1)), q(vh))
    out = linear(P, f"{name}.out_proj", out.transpose(1, 2).reshape(B, H * W, C), q)
    return out.reshape(B, H, W, C).permute(0, 3, 1, 2) + x


def downsample(P, name: str, x, q: Q):
    return F.pad(conv(P, name, x, q, stride=2, padding=0), (0, 1, 0, 1))


def upsample(P, name: str, x, q: Q):
    return conv(P, name, F.interpolate(x, scale_factor=2, mode="nearest"), q)


# ------------------------------------------------------------- the UNet


def time_embedding(P, t, q: Q):
    angles = t.float()[:, None] / P["time_embedding.factor"].float()
    emb = torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1).to(P["in_conv.weight"].dtype)
    h = F.silu(linear(P, "time_embedding.embeddings.0", emb, q))
    return linear(P, "time_embedding.embeddings.2", h, q)


def unet_stage(P, prefix: str, x, temb, arch: dict, q: Q, skip=None, sites=None):
    if skip is not None:
        x = torch.cat([x, skip], dim=1)
    G, silu_t = arch["num_groups"], F.silu(temb)
    for j in range(arch["num_res_layers"]):
        h = conv(P, f"{prefix}.first_halfs.{j}.layers.2",
                 F.silu(group_norm(P, f"{prefix}.first_halfs.{j}.layers.0", x, G)), q)
        h = h + linear(P, f"{prefix}.time_projs.{j}.1", silu_t, q)[:, :, None, None]
        h = conv(P, f"{prefix}.second_halfs.{j}.layers.2",
                 F.silu(group_norm(P, f"{prefix}.second_halfs.{j}.layers.0", h, G)), q)
        h = h + conv(P, f"{prefix}.residuals.{j}", x, q)
        x = attention(P, f"{prefix}.self_attns.{j}", h, arch["num_heads"], G, q, sites)
    return x


def unet(P, arch: dict, x, t, context=None, mask=None, q: Q = ident, sites: list | None = None):
    """NHWC latents (B, h, w, z), timesteps (B,), class ids (B,) or None,
    condition mask (B, 1) or None -> the noise prediction, NHWC."""
    temb = time_embedding(P, t, q)
    if context is not None:
        c = P["class_embedding.weight"][context]
        temb = temb + (c if mask is None else c * mask.to(c.dtype))
    h = conv(P, "in_conv", x.permute(0, 3, 1, 2).to(temb.dtype), q)
    stages, skips, n_down = _stage_blocks(arch), [], len(arch["channels"]) - 1
    n_mid = len(arch["mid_channels"]) - 1
    for k, (prefix, _, _, _) in enumerate(stages):
        if k < n_down:
            h = unet_stage(P, prefix, h, temb, arch, q, sites=sites)
            skips.append(h)
            h = downsample(P, f"downsamples.{k}.down", h, q)
        elif k < n_down + n_mid:
            h = unet_stage(P, prefix, h, temb, arch, q, sites=sites)
        else:
            i = k - n_down - n_mid
            h = upsample(P, f"upsamples.{i}.conv", h, q)
            h = unet_stage(P, prefix, h, temb, arch, q, skip=skips.pop(), sites=sites)
    h = F.silu(group_norm(P, "out_conv.0", h, arch["num_groups"]))
    return conv(P, "out_conv.2", h, q).permute(0, 2, 3, 1)


# ------------------------------------------------------------- the VAE


def _trunk(P, arch: dict, part: str, x, q: Q, sites=None):
    trunk = "encoder" if part == "down" else "decoder"
    G = arch["num_groups"]
    for kind, i, cin, cout in vae_layers(arch, part):
        name = f"{trunk}.{part}.{i}"
        if kind in ("conv", "conv1"):
            x = conv(P, name, x, q)
        elif kind == "gn":
            x = group_norm(P, name, x, G)
        elif kind == "silu":
            x = F.silu(x)
        elif kind == "attn":
            x = attention(P, name, x, arch["num_heads"], G, q, sites)
        elif kind == "down":
            x = downsample(P, f"{name}.down", x, q)
        elif kind == "up":
            x = upsample(P, f"{name}.conv", x, q)
        else:  # res
            h = conv(P, f"{name}.branch.2", F.silu(group_norm(P, f"{name}.branch.0", x, G)), q)
            h = conv(P, f"{name}.branch.5", F.silu(group_norm(P, f"{name}.branch.3", h, G)), q)
            skip = conv(P, f"{name}.residual_wrapper", x, q) if cin != cout else x
            x = h + skip
    return x


def vae_encode(P, arch: dict, x, q: Q = ident, sites=None):
    """NHWC images -> the encoder's (mean || log_var) map, NHWC."""
    return _trunk(P, arch, "down", x.permute(0, 3, 1, 2), q, sites).permute(0, 2, 3, 1)


def vae_decode(P, arch: dict, z, q: Q = ident, sites=None):
    """NHWC latents -> NHWC images."""
    return _trunk(P, arch, "up", z.permute(0, 3, 1, 2), q, sites).permute(0, 2, 3, 1)


def kl_sample(raw, noise):
    """(z, the KL term averaged over the batch) from the (mean || log_var)
    map, log_var clipped to [-30, 20]."""
    mean, log_var = torch.chunk(raw, 2, dim=-1)
    log_var = torch.clamp(log_var, -30.0, 20.0)
    kl = -0.5 * torch.sum(1.0 + log_var - mean**2 - torch.exp(log_var), dim=(1, 2, 3))
    return mean + noise * torch.exp(0.5 * log_var), kl.mean()


# ------------------------------------------------------------- stage-1 losses


def discriminator(P, n_convs: int, x, q: Q = ident):
    """NHWC images -> NHWC logits; BatchNorm on the middle convs with the
    batch's mean and biased variance (train mode), LeakyReLU(0.2) after
    every conv but the last."""
    h = x.permute(0, 3, 1, 2)
    for i in range(n_convs):
        h = conv(P, f"convs.{i}", h, q, stride=1 if i == n_convs - 1 else 2, padding=1)
        if f"norms.{i}.weight" in P:
            mean = h.mean(dim=(0, 2, 3))
            var = torch.clamp((h * h).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            h = ((h - mean[:, None, None]) * torch.rsqrt(var + 1e-5)[:, None, None]
                 * P[f"norms.{i}.weight"][:, None, None] + P[f"norms.{i}.bias"][:, None, None])
        if i < n_convs - 1:
            h = F.leaky_relu(h, 0.2)
    return h.permute(0, 2, 3, 1)


def lpips(W, real, fake, q: Q = ident):
    """The batch mean of the LPIPS distance between NHWC images in [-1, 1]."""
    shift = real.new_tensor(LPIPS_SHIFT)
    scale = real.new_tensor(LPIPS_SCALE)

    def taps(x):
        h = ((x - shift) / scale).permute(0, 3, 1, 2)
        out, i = [], 0
        for s, (_, n) in enumerate(VGG16_STAGES):
            for _ in range(n):
                h = F.relu(conv(W, f"conv.{i}", h, q, padding=1))
                i += 1
            out.append(h)
            if s < len(VGG16_STAGES) - 1:
                h = F.max_pool2d(h, 2)
        return out

    total = 0.0
    for k, (fa, fb) in enumerate(zip(taps(real), taps(fake))):
        na = fa / (torch.linalg.vector_norm(fa, dim=1, keepdim=True) + 1e-10)
        nb = fb / (torch.linalg.vector_norm(fb, dim=1, keepdim=True) + 1e-10)
        dist = torch.sum((na - nb) ** 2 * W[f"lin.{k}"][None, :, None, None], dim=1)
        total = total + dist.mean(dim=(1, 2))
    return total.mean()


def bce_with_logits(logits, target: float):
    return torch.mean(torch.clamp(logits, min=0.0) - logits * target
                      + torch.log1p(torch.exp(-logits.abs())))
