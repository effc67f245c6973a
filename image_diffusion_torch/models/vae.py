"""Stage-1 autoencoder (KL or VQ bottleneck): the roundtrip forward of
KL training, inference, and the KL reparametrization the stage-2 trainer
applies to stored latents.

The encoder and decoder trunks are `nn.Sequential`s indexed like the
original PyTorch implementation's (`encoder.down.{i}`, `decoder.up.{i}`,
a parameterless `nn.Identity` holding the index of each SiLU, which runs
inside the GroupNorm before it), so its state dicts load as they are.
The decoder tracks attention resolutions from the true latent resolution
(the original's bookkeeping was off by one level; no shipped config has
attention there, so outputs agree).  The encoder's and the
decoder's mid-block attention (one head, d = the widest channel count,
384 in the shipped config) take the flash kernel in bf16 (`ops.site_route`).

The "ldm" layout (`VAEArch.layout`) is the CompVis latent-diffusion
`AutoencoderKL` decoder that DiT samples through (stabilityai/sd-vae-ft-ema,
`ldm/modules/diffusionmodules/model.py:Decoder` with
`models/first_stage_models/kl-f8/config.yaml`), under its own module names
(`post_quant_conv`, `decoder.conv_in`, `decoder.mid.block_1.norm1`,
`decoder.up.{level}.block.{i}.conv1`, `decoder.norm_out`, ...): a 1x1
post-quant conv, conv_in, a mid ResBlock / one-head attention / ResBlock,
then per level from the widest dec_num_res_blocks + 1 ResBlocks and a
nearest-2x upsample (not after the last), norm_out + SiLU, conv_out;
GroupNorm eps 1e-6.  `LDMDecoderVAE` holds it, decode only (no encoder).
Its mid attention (d = 512) takes the plain route (`ops.site_route`).

The VQ codebook holds its embeddings and EMA statistics as fp32 buffers
(state, not parameters), finds nearest codes in fp32, reports the
commitment loss and the code perplexity, and in training updates itself
by the EMA of the batches' code statistics, or hands those statistics to
the caller for grad accumulation.  Under data parallelism (`group` set by
the trainer) the statistics and the perplexity's histogram are summed over
the data group, so every rank applies the global batch's update, as under
the JAX package's global view.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..core.config import VAEArch
from .layers import Downsample, GroupNorm, Residual, SpatialSelfAttention, Upsample, attend, conv

LDM_EPS = 1e-6  # the ldm layout's GroupNorm eps (`Normalize`)


def _stage(layers: list, cur: int, cout: int, n_res: int, groups: int) -> int:
    for _ in range(n_res):
        layers.append(Residual(cur, cout, groups))
        cur = cout
    return cur


class Encoder(nn.Module):
    """Stem, [res x N, attn?, down] per stage, bottleneck, z."""

    def __init__(self, arch: VAEArch, z_channels: int):
        super().__init__()
        ch, n, g = arch.channels, arch.enc_num_res_blocks, arch.num_groups
        layers: list[nn.Module] = [conv(arch.in_channels, ch[0])]
        cur, res = ch[0], arch.init_resolution
        for c in ch[1:]:
            cur = _stage(layers, cur, c, n, g)
            if res in arch.attn_resolutions:
                layers.append(SpatialSelfAttention(cur, arch.num_heads, g))
            layers.append(Downsample(cur))
            res //= 2
        cur = _stage(layers, cur, ch[-1], n, g)
        layers.append(SpatialSelfAttention(cur, arch.num_heads, g))
        cur = _stage(layers, cur, ch[-1], n, g)
        layers += [GroupNorm(g, cur, silu=True), nn.Identity(), conv(cur, z_channels),
                   conv(z_channels, z_channels, 1)]
        self.down = nn.Sequential(*layers)

    def forward(self, x):
        return self.down(x)


class Decoder(nn.Module):
    """Mirror of the encoder over the reversed channel list."""

    def __init__(self, arch: VAEArch):
        super().__init__()
        ch, n, g = arch.channels[::-1], arch.dec_num_res_blocks, arch.num_groups
        layers: list[nn.Module] = [conv(arch.z_dim, arch.z_dim, 1), conv(arch.z_dim, ch[0])]
        cur = _stage(layers, ch[0], ch[0], n, g)
        layers.append(SpatialSelfAttention(cur, arch.num_heads, g))
        cur = _stage(layers, cur, ch[0], n, g)
        res = arch.latent_resolution
        for c in ch[1:]:
            cur = _stage(layers, cur, c, n, g)
            if res in arch.attn_resolutions:
                layers.append(SpatialSelfAttention(cur, arch.num_heads, g))
            layers.append(Upsample(cur))
            res *= 2
        cur = _stage(layers, cur, ch[-1], n, g)
        layers += [GroupNorm(g, cur, silu=True), nn.Identity(), conv(cur, arch.in_channels)]
        self.up = nn.Sequential(*layers)

    def forward(self, z):
        return self.up(z)


class LDMResBlock(nn.Module):
    """LDM's `ResnetBlock` without a time embedding: norm1 + SiLU, conv1,
    norm2 + SiLU, conv2, plus the input (a 1x1 `nin_shortcut` on a channel
    change)."""

    def __init__(self, cin: int, cout: int, groups: int):
        super().__init__()
        self.norm1 = GroupNorm(groups, cin, silu=True, eps=LDM_EPS)
        self.conv1 = conv(cin, cout)
        self.norm2 = GroupNorm(groups, cout, silu=True, eps=LDM_EPS)
        self.conv2 = conv(cout, cout)
        self.nin_shortcut = conv(cin, cout, 1) if cin != cout else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class LDMAttnBlock(nn.Module):
    """LDM's `AttnBlock`: GroupNorm, 1x1 convs q, k, v, one head over the
    H*W tokens, 1x1 `proj_out`, plus the input."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.norm = GroupNorm(groups, channels, eps=LDM_EPS)
        self.q, self.k, self.v, self.proj_out = (conv(channels, channels, 1) for _ in range(4))

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)
        q, k, v = (m(h).permute(0, 2, 3, 1).reshape(B, H * W, C) for m in (self.q, self.k, self.v))
        out = attend(q, k, v, 1).reshape(B, H, W, C).permute(0, 3, 1, 2)
        return x + self.proj_out(out)


class LDMDecoder(nn.Module):
    """The latent-diffusion KL decoder (see the module doc); `channels` are
    ch * ch_mult from the narrowest level."""

    def __init__(self, arch: VAEArch):
        super().__init__()
        ch, g, n = arch.channels, arch.num_groups, arch.dec_num_res_blocks + 1
        cur = ch[-1]
        self.conv_in = conv(arch.z_dim, cur)
        self.mid = nn.Module()
        self.mid.block_1 = LDMResBlock(cur, cur, g)
        self.mid.attn_1 = LDMAttnBlock(cur, g)
        self.mid.block_2 = LDMResBlock(cur, cur, g)
        levels: list[nn.Module] = [nn.Module() for _ in ch]
        for i in reversed(range(len(ch))):
            level = levels[i]
            level.block = nn.ModuleList()
            for _ in range(n):
                level.block.append(LDMResBlock(cur, ch[i], g))
                cur = ch[i]
            if i > 0:
                level.upsample = Upsample(cur)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(g, cur, silu=True, eps=LDM_EPS)
        self.conv_out = conv(cur, arch.in_channels)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for i in reversed(range(len(self.up))):
            for block in self.up[i].block:
                h = block(h)
            if i > 0:
                h = self.up[i].upsample(h)
        return self.conv_out(self.norm_out(h))


def nearest_code(flat: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """argmin_k |z - e_k|^2 as |z|^2 - 2 z.e + |e|^2, all fp32.
    flat: (N, C), emb: (K, C) -> (N,) int64."""
    z_sq = torch.sum(flat**2, dim=-1, keepdim=True)
    e_sq = torch.sum(emb**2, dim=-1)
    distances = z_sq - 2.0 * (flat @ emb.T) + e_sq[None, :]
    return torch.argmin(distances, dim=-1)


def codebook_ema_update(ema_cluster_size, ema_w, counts, dw, gamma: float, epsilon: float = 1e-5):
    """One EMA codebook update from batch statistics -> (cluster sizes,
    ema_w, embeddings): cluster sizes cs * gamma + (1 - gamma) * counts,
    Laplace-smoothed to (cs + eps) / (n + K eps) * n; ema_w * gamma +
    (1 - gamma) * dw; embeddings ema_w / smoothed sizes."""
    new_cs = ema_cluster_size * gamma + (1.0 - gamma) * counts
    n = torch.sum(new_cs)
    smoothed = (new_cs + epsilon) / (n + new_cs.shape[0] * epsilon) * n
    new_ema_w = ema_w * gamma + (1.0 - gamma) * dw
    return smoothed, new_ema_w, new_ema_w / smoothed[:, None]


class Codebook(nn.Module):
    """VQ codebook: nearest-code lookup over fp32 embeddings, updated by an
    EMA of the batches' code statistics in training.

    The embeddings and the EMA sums are buffers, not parameters: no
    optimizer sees them (the JAX package's non-trainable `codebook`
    collection).  They stay fp32 whatever the compute dtype, and the
    embeddings keep the state-dict key `embeddings.weight`.  `group`: the
    process group its statistics are summed over, or None."""

    def __init__(self, size: int, dim: int, gamma: float | None):
        super().__init__()
        self.gamma = gamma
        self.group = None
        self.embeddings = nn.Module()
        self.embeddings.register_buffer("weight", torch.zeros(size, dim))
        self.register_buffer("ema_cluster_size", torch.zeros(size))
        self.register_buffer("ema_w", torch.zeros(size, dim))

    def reset_state(self, generator: torch.Generator | None = None):
        """Embeddings and EMA sums from U(+-1/K), as the JAX package's and
        the original's codebook draw them (zero without a generator);
        cluster sizes zero."""
        bound = 1.0 / self.ema_w.shape[0]
        for t in (self.embeddings.weight, self.ema_w):
            t.copy_(torch.zeros(t.shape) if generator is None
                    else torch.empty(t.shape).uniform_(-bound, bound, generator=generator))
        self.ema_cluster_size.zero_()

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """NHWC latents -> nearest codes, fp32, through the straight-through
        form flat + (quant - flat) the training path uses."""
        return self(z)[0]

    def indices(self, z: torch.Tensor) -> torch.Tensor:
        """NHWC latents -> the nearest code of each position, (B, H, W)."""
        with torch.no_grad():
            return nearest_code(z.reshape(-1, z.shape[-1]).float(),
                                self.embeddings.weight).reshape(z.shape[:-1])

    def empty_stats(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Zero (counts (K,), dw (K, C)) for `forward`'s `ema_stats`."""
        return torch.zeros_like(self.ema_cluster_size), torch.zeros_like(self.ema_w)

    @torch.no_grad()
    def ema_update(self, counts: torch.Tensor, dw: torch.Tensor) -> None:
        """Apply one EMA update from (counts, dw), in place."""
        cs, w, emb = codebook_ema_update(self.ema_cluster_size, self.ema_w, counts, dw,
                                         self.gamma)
        self.ema_cluster_size.copy_(cs)
        self.ema_w.copy_(w)
        self.embeddings.weight.copy_(emb)

    def forward(self, z: torch.Tensor, train: bool = False,
                ema_stats: tuple[torch.Tensor, torch.Tensor] | None = None,
                valid_mask: torch.Tensor | None = None):
        """NHWC latents -> (nearest codes through the straight-through form,
        fp32; mean squared distance to the codes, fp32; the code usage
        perplexity exp(-sum p log(p + 1e-6))).

        The codes are looked up before any update.  `train`: the batch's
        statistics, counts (the code histogram) and dw (the sum of the fp32
        tokens of each code, the one-hot codes' product with the tokens as
        in the JAX package), update the EMA state in place; or, with
        `ema_stats` (from `empty_stats`), are added to it and nothing is
        updated, so that grad accumulation applies one `ema_update` from
        the sums over its micro-batches.  `valid_mask` (B,) bool: the
        perplexity counts only those rows' positions (padded dev batches)."""
        flat = z.reshape(-1, z.shape[-1]).float()
        emb = self.embeddings.weight
        with torch.no_grad():
            idx = nearest_code(flat, emb)
        quant = emb[idx]
        counts = torch.bincount(idx, minlength=emb.shape[0]).float()
        n_tokens = idx.numel()
        if self.group is not None:  # the global batch's histogram
            dist.all_reduce(counts, group=self.group)
            n_tokens *= dist.get_world_size(self.group)
        if train:
            with torch.no_grad():
                # JAX's statistic: the one-hot codes' product with the
                # tokens, a sum in a fixed order (index_add_ accumulates in
                # arrival order, on the card through atomics: not
                # deterministic, and ~10x the float64 error at full width)
                one_hot = torch.zeros(idx.numel(), emb.shape[0], device=flat.device)
                dw = one_hot.scatter_(1, idx[:, None], 1.0).T @ flat
                if self.group is not None:
                    dist.all_reduce(dw, group=self.group)
                if ema_stats is None:
                    self.ema_update(counts, dw)
                else:
                    ema_stats[0].add_(counts)
                    ema_stats[1].add_(dw)
        if valid_mask is None:
            probs = counts / n_tokens
        else:
            tok = valid_mask.float().repeat_interleave(idx.numel() // valid_mask.numel())
            hist, n_valid = torch.bincount(idx, weights=tok, minlength=emb.shape[0]), tok.sum()
            if self.group is not None:
                both = torch.cat([hist, n_valid[None]])
                dist.all_reduce(both, group=self.group)
                hist, n_valid = both[:-1], both[-1]
            probs = hist / torch.clamp(n_valid, min=1.0)
        perplexity = torch.exp(-torch.sum(probs * torch.log(probs + 1e-6)))
        commitment = torch.mean((quant - flat) ** 2)
        return (flat + (quant - flat).detach()).reshape(z.shape), commitment, perplexity


class VAE(nn.Module):
    def __init__(self, arch: VAEArch, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        z_channels = arch.z_dim if arch.bottleneck == "vq" else 2 * arch.z_dim
        self.encoder = Encoder(arch, z_channels)
        self.decoder = Decoder(arch)
        if arch.bottleneck == "vq":
            self.codebook = Codebook(arch.codebook_size, arch.z_dim, arch.codebook_gamma)

    @staticmethod
    def reparametrize(latents: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """z from a stored (mean || log_var) map on the last axis, all fp32:
        mean + noise * exp(log_var / 2) with log_var clipped to [-30, 20].
        The diffusion trainer applies it to pre-extracted KL latents at
        every step, with `noise` (fp32, the shape of mean) drawn by the
        caller."""
        mean, log_var = torch.chunk(latents.float(), 2, dim=-1)
        std = torch.exp(0.5 * torch.clamp(log_var, -30.0, 20.0))
        return mean + noise * std

    def forward(self, x: torch.Tensor, sample: bool | None = None,
                noise: torch.Tensor | None = None, train: bool = False,
                ema_stats: tuple[torch.Tensor, torch.Tensor] | None = None,
                valid_mask: torch.Tensor | None = None):
        """NHWC images -> (x_hat NHWC in the compute dtype, prior loss,
        perplexity), the roundtrip of stage-1 training.  KL decodes the
        reparametrized z when `sample` (the default for KL), else the
        posterior mean; the other arguments as in `encode`."""
        if sample is None:
            sample = self.arch.bottleneck == "kl"
        z, prior, perplexity = self.encode(x, sample=sample, noise=noise, train=train,
                                           ema_stats=ema_stats, valid_mask=valid_mask)
        if self.arch.bottleneck == "kl" and not sample:
            z = z[..., : self.arch.z_dim]
        return self.decode(z), prior, perplexity

    def encode(self, x: torch.Tensor, sample: bool = False, noise: torch.Tensor | None = None,
               train: bool = False, ema_stats: tuple[torch.Tensor, torch.Tensor] | None = None,
               valid_mask: torch.Tensor | None = None):
        """NHWC images -> (z, prior loss, perplexity), the JAX `encode`.

        KL: the encoder's mean || log_var map with log_var clipped to
        [-30, 20]; the prior loss is the KL divergence summed over H, W, C
        and averaged over the batch (fp32).  With `sample`, z = mean + noise
        * exp(log_var / 2) in the compute dtype, `noise` (fp32, the shape of
        mean; drawn here when None) being the reparametrization draw; else
        z is the raw map, the format of stored latents.  Perplexity is 0.
        VQ: the nearest codes (straight-through), beta times the commitment
        loss, and the batch's code perplexity; `train`, `ema_stats` and
        `valid_mask` as in `Codebook.forward` (KL ignores them)."""
        raw = self._encoder(x)
        if self.arch.bottleneck == "vq":
            if sample:
                raise ValueError("Cannot sample from the VQ model!")
            quant, commitment, perplexity = self.codebook(raw, train, ema_stats, valid_mask)
            return quant.to(self.dtype), self.arch.codebook_beta * commitment, perplexity
        mean, log_var = torch.chunk(raw.float(), 2, dim=-1)
        log_var = torch.clamp(log_var, -30.0, 20.0)
        kl = -0.5 * torch.sum(1.0 + log_var - mean**2 - torch.exp(log_var), dim=(1, 2, 3))
        if sample:
            if noise is None:
                noise = torch.randn_like(mean)
            raw = (mean + noise * torch.exp(0.5 * log_var)).to(self.dtype)
        return raw, kl.mean(), kl.new_zeros(())

    def _encoder(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x.to(self.dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def encode_indices(self, x: torch.Tensor) -> torch.Tensor:
        """VQ only: NHWC images -> the nearest code of each latent position,
        (B, h, w), without touching the codebook's state."""
        if self.arch.bottleneck != "vq":
            raise ValueError("encode_indices requires the VQ bottleneck")
        return self.codebook.indices(self._encoder(x))

    def decode(self, z: torch.Tensor, quantize: bool = False) -> torch.Tensor:
        """NHWC latents -> NHWC images in the compute dtype; `quantize`
        (VQ only) snaps the latents to their nearest codes first."""
        if quantize:
            if self.arch.bottleneck != "vq":
                raise ValueError("Cannot quantize in the KL model!")
            z = self.codebook.quantize(z)
        return self.decoder(z.to(self.dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class LDMDecoderVAE(nn.Module):
    """The ldm layout (see the module doc): the 1x1 `post_quant_conv` and
    `LDMDecoder`, decode only; NHWC latents in, NHWC images out, as
    `VAE.decode`."""

    def __init__(self, arch: VAEArch, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        self.post_quant_conv = conv(arch.z_dim, arch.z_dim, 1)
        self.decoder = LDMDecoder(arch)

    def decode(self, z: torch.Tensor, quantize: bool = False) -> torch.Tensor:
        if quantize:
            raise ValueError("Cannot quantize in the KL model!")
        z = self.post_quant_conv(z.to(self.dtype).permute(0, 3, 1, 2))
        return self.decoder(z).permute(0, 2, 3, 1)
