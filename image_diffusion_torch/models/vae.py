"""Stage-1 autoencoder (KL or VQ bottleneck): the roundtrip forward of
KL training, inference, and the KL reparametrization the stage-2 trainer
applies to stored latents.

The encoder and decoder trunks are `nn.Sequential`s indexed like the
original PyTorch implementation's (`encoder.down.{i}`, `decoder.up.{i}`,
parameterless SiLUs holding an index), so its state dicts load as they
are.  The decoder tracks attention resolutions from the true latent
resolution (the original's bookkeeping was off by one level; no shipped
config has attention there, so outputs agree).  The encoder's and the
decoder's mid-block attention (one head, d = the widest channel count,
384 in the shipped config) take the flash kernel in bf16 (`ops.site_route`).

The VQ codebook is inference-only here: it holds the embeddings (and the
EMA statistics, so a trained state loads strictly), finds nearest codes in
fp32 and reports the commitment loss and perplexity; its EMA update, VQ
training, is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import VAEArch
from .layers import Downsample, GroupNorm, Residual, SpatialSelfAttention, Upsample, conv


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
        layers += [GroupNorm(g, cur), nn.SiLU(), conv(cur, z_channels),
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
        layers += [GroupNorm(g, cur), nn.SiLU(), conv(cur, arch.in_channels)]
        self.up = nn.Sequential(*layers)

    def forward(self, z):
        return self.up(z)


def nearest_code(flat: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """argmin_k |z - e_k|^2 as |z|^2 - 2 z.e + |e|^2, all fp32.
    flat: (N, C), emb: (K, C) -> (N,) int64."""
    z_sq = torch.sum(flat**2, dim=-1, keepdim=True)
    e_sq = torch.sum(emb**2, dim=-1)
    distances = z_sq - 2.0 * (flat @ emb.T) + e_sq[None, :]
    return torch.argmin(distances, dim=-1)


class Codebook(nn.Module):
    """VQ codebook: nearest-code lookup over fp32 embeddings."""

    def __init__(self, size: int, dim: int):
        super().__init__()
        self.embeddings = nn.Embedding(size, dim)
        self.register_buffer("ema_cluster_size", torch.zeros(size))
        self.register_buffer("ema_w", torch.zeros(size, dim))

    def reset_state(self, generator: torch.Generator | None = None):
        """Embeddings and EMA sums from U(+-1/K), as the JAX package's and
        the original's codebook draw them (zero without a generator);
        cluster sizes zero."""
        bound = 1.0 / self.embeddings.num_embeddings
        for t in (self.embeddings.weight, self.ema_w):
            t.copy_(torch.zeros(t.shape) if generator is None
                    else torch.empty(t.shape).uniform_(-bound, bound, generator=generator))
        self.ema_cluster_size.zero_()

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """NHWC latents -> nearest codes, fp32, through the straight-through
        form flat + (quant - flat) the training path uses."""
        return self.lookup(z)[0]

    def lookup(self, z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (quantize(z), mean squared distance to the codes (fp32), the
        codes' usage perplexity exp(-sum p log(p + 1e-6)))."""
        flat = z.reshape(-1, z.shape[-1]).float()
        emb = self.embeddings.weight.float()
        idx = nearest_code(flat, emb)
        quant = emb[idx]
        probs = torch.bincount(idx, minlength=emb.shape[0]).float() / idx.numel()
        perplexity = torch.exp(-torch.sum(probs * torch.log(probs + 1e-6)))
        commitment = torch.mean((quant.detach() - flat) ** 2)
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
            self.codebook = Codebook(arch.codebook_size, arch.z_dim)

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
                noise: torch.Tensor | None = None):
        """NHWC images -> (x_hat NHWC in the compute dtype, prior loss,
        perplexity), the roundtrip of stage-1 training.  KL decodes the
        reparametrized z when `sample` (the default for KL), else the
        posterior mean; `noise` as in `encode`."""
        if sample is None:
            sample = self.arch.bottleneck == "kl"
        z, prior, perplexity = self.encode(x, sample=sample, noise=noise)
        if self.arch.bottleneck == "kl" and not sample:
            z = z[..., : self.arch.z_dim]
        return self.decode(z), prior, perplexity

    def encode(self, x: torch.Tensor, sample: bool = False, noise: torch.Tensor | None = None):
        """NHWC images -> (z, prior loss, perplexity), the JAX `encode`.

        KL: the encoder's mean || log_var map with log_var clipped to
        [-30, 20]; the prior loss is the KL divergence summed over H, W, C
        and averaged over the batch (fp32).  With `sample`, z = mean + noise
        * exp(log_var / 2) in the compute dtype, `noise` (fp32, the shape of
        mean; drawn here when None) being the reparametrization draw; else
        z is the raw map, the format of stored latents.  Perplexity is 0.
        VQ: the nearest codes (straight-through), beta times the commitment
        loss, and the batch's code perplexity."""
        raw = self.encoder(x.to(self.dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if self.arch.bottleneck == "vq":
            if sample:
                raise ValueError("Cannot sample from the VQ model!")
            quant, commitment, perplexity = self.codebook.lookup(raw)
            return quant.to(self.dtype), self.arch.codebook_beta * commitment, perplexity
        mean, log_var = torch.chunk(raw.float(), 2, dim=-1)
        log_var = torch.clamp(log_var, -30.0, 20.0)
        kl = -0.5 * torch.sum(1.0 + log_var - mean**2 - torch.exp(log_var), dim=(1, 2, 3))
        if sample:
            if noise is None:
                noise = torch.randn_like(mean)
            raw = (mean + noise * torch.exp(0.5 * log_var)).to(self.dtype)
        return raw, kl.mean(), kl.new_zeros(())

    def decode(self, z: torch.Tensor, quantize: bool = False) -> torch.Tensor:
        """NHWC latents -> NHWC images in the compute dtype; `quantize`
        (VQ only) snaps the latents to their nearest codes first."""
        if quantize:
            if self.arch.bottleneck != "vq":
                raise ValueError("Cannot quantize in the KL model!")
            z = self.codebook.quantize(z)
        return self.decoder(z.to(self.dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
