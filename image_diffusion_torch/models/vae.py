"""Stage-1 autoencoder (KL or VQ bottleneck), for inference, and the KL
reparametrization the stage-2 trainer applies to stored latents.

The encoder and decoder trunks are `nn.Sequential`s indexed like the
original PyTorch implementation's (`encoder.down.{i}`, `decoder.up.{i}`,
parameterless SiLUs holding an index), so its state dicts load as they
are.  The decoder tracks attention resolutions from the true latent
resolution (the original's bookkeeping was off by one level; no shipped
config has attention there, so outputs agree).

The VQ codebook is inference-only here: it holds the embeddings (and the
EMA statistics, so a trained state loads strictly) and finds nearest
codes in fp32; its EMA update belongs to stage-1 training.
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

    def reset_buffers(self):
        self.ema_cluster_size.zero_()
        self.ema_w.zero_()

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """NHWC latents -> nearest codes, fp32, through the straight-through
        form flat + (quant - flat) the training path uses."""
        flat = z.reshape(-1, z.shape[-1]).float()
        emb = self.embeddings.weight.float()
        quant = emb[nearest_code(flat, emb)]
        return (flat + (quant - flat)).reshape(z.shape)


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

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> the raw encoder map, NHWC: mean || log_var for the
        KL bottleneck, pre-quantization latents for VQ."""
        return self.encoder(x.to(self.dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor, quantize: bool = False) -> torch.Tensor:
        """NHWC latents -> NHWC images in the compute dtype; `quantize`
        (VQ only) snaps the latents to their nearest codes first."""
        if quantize:
            if self.arch.bottleneck != "vq":
                raise ValueError("Cannot quantize in the KL model!")
            z = self.codebook.quantize(z)
        return self.decoder(z.to(self.dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
