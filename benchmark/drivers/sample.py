"""Closed-loop sampling calls: one caller asks for a batch of classifier-
free guided images, waits, and asks again, as `eval_fid` and offline
sample generation do.

A unit is one `DiffusionPipeline.sample_batch` call of `images_per_class`
images of every class at guidance `cfg_scale` (the call `sample(scale,
num_images=images_per_class, ...)` makes after drawing its initial
latents), `steps` steps of `sampler`, then the decode.  Call i's initial
latents are drawn on the card from the run's seed and i.  The weights are
drawn on the card from the seed in the compute dtype, as a bundle serves
them.

The check follows the program step by step from its own states: a
50-step guided chain amplifies rounding until two correct runs in
different precisions part (the benchmark's calibration in PERF.md), so
each step is judged alone.  Each call checks `checked_per_call` of its
images, rows drawn in set-up from the seed and the call's index: hooks on
the UNet and the decoder copy those rows of the latents the call passes
them (one small gather a UNet call and one a decode; set-up's warm-up call
runs them too), and the call keeps those rows of its images.  After the
window the reference takes the program's latent before each step to the
next, and decodes the program's final latent; the numbers compared are
  * start_gap: the largest difference of the first state from the
    benchmark's initial latent (0: the call started where it was told);
  * step_gap: the worst step's |program's next latent - reference's| over
    |reference's next latent - the state it started from|;
  * decode_gap: the worst image's relative L2 distance to the reference's
    decode of the program's final latent.
"""

from __future__ import annotations

import numpy as np
import torch

import yardstick as Y
from reference import lowp, nets, steps as ref

RATE = ("images_per_s", "images/s")
BLOCK = 256  # reference rows a UNet call
PICK_CALLS = 64  # rows of the table of checked rows; call i takes row i mod PICK_CALLS


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from image_diffusion_torch.core.config import ScheduleConfig, UNetArch, VAEArch, _build
        from image_diffusion_torch.pipelines.diffusion import DiffusionPipeline

        Y.mark("program imported")

        if traffic["sampler"] != "ddim" or traffic["eta"] != 0:
            raise ValueError("the reference states the DDIM sampler at eta 0")
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.dtype = getattr(torch, config["compute_dtype"])
        self.ua, self.va = nets.unet_arch(config), config["vae"]
        Pu, Pv = self.weights()
        nc, per = self.ua["num_classes"], traffic["images_per_class"]
        self.pipe = DiffusionPipeline(_build(VAEArch, self.va), Pv, _build(UNetArch, self.ua), Pu,
                                      _build(ScheduleConfig, config), [str(i) for i in range(nc)],
                                      dtype=self.dtype, device=device)
        del Pu, Pv
        Y.mark("weights drawn, pipeline built")
        self.K = nc * per
        self.labels = torch.arange(nc).repeat(per)
        self.scales = torch.full((self.K,), float(traffic["cfg_scale"]))
        r = nets.latent_res(self.va)
        self.latent = (r, r, self.ua["z_dim"])
        # the checked rows of call i: row i mod PICK_CALLS of the table
        rng = np.random.default_rng(Y.derive_seed(seed, "check"))
        self.picks = np.stack([np.sort(rng.choice(self.K, traffic["checked_per_call"], replace=False))
                               for _ in range(PICK_CALLS)])
        self.pick_index = torch.as_tensor(self.picks, device=device)
        self.calls: list[dict] = [{"i": 0, "states": []}]  # the warm-up call's, dropped after it
        self.pipe.unet.register_forward_pre_hook(self._keep_state)
        self.pipe.vae.decoder.register_forward_pre_hook(self._keep_final)
        self._call(self._x(-1), traffic["warmup_steps"])
        self.calls.clear()
        Y.mark("warmed")
        self.min_units = 1

        n = traffic["steps"]
        fl = config["flops"]
        self.unit_items, self.unit_steps = self.K, n
        self.unit_flops = (n * 2 * self.K * fl["unet_forward_per_row"]
                           + self.K * fl["vae_decode_per_image"])
        sites = Y.unet_attention_sites(self.ua, r)
        self.unit_attention = [Y.attention_forward(2 * self.K, N, C) for N, C in sites] * n + [
            Y.attention_forward(self.K, N, C) for N, C in Y.vae_attention_sites(self.va)["decode"]]

    def weights(self) -> tuple[dict, dict]:
        """The UNet's and the VAE's weights, drawn from the seed on the card
        in the compute dtype."""
        return (nets.make_weights(nets.unet_leaves(self.ua), Y.derive_seed(self.seed, "unet"),
                                  self.device, self.dtype),
                nets.make_weights(nets.vae_leaves(self.va), Y.derive_seed(self.seed, "vae"),
                                  self.device, self.dtype))

    def _x(self, i: int) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed(Y.derive_seed(self.seed, "call", i))
        return torch.randn((self.K, *self.latent), generator=g, device=self.device)

    def _call(self, x, n_steps: int):
        t = self.traffic
        return self.pipe.sample_batch(self.labels, self.scales, x, sampler=t["sampler"],
                                      num_inference_steps=n_steps, eta=t["eta"])

    def _rows(self, i: int) -> torch.Tensor:
        return self.pick_index[i % PICK_CALLS]

    def _keep_state(self, module, args) -> None:
        call = self.calls[-1]
        call["states"].append(args[0].index_select(0, self._rows(call["i"])))

    def _keep_final(self, module, args) -> None:
        call = self.calls[-1]
        call["final"] = args[0].index_select(0, self._rows(call["i"]))

    def run_unit(self) -> None:
        i = len(self.calls)
        self.calls.append({"i": i, "states": []})
        images = self._call(self._x(i), self.traffic["steps"])
        self.calls[-1]["images"] = images.index_select(0, self._rows(i))

    def check(self, control: bool = False) -> dict:
        """The compared numbers of the program (see the module doc); with
        `control` also those of the fp8 reference in its place
        ("control.<name>")."""
        calls, self.calls, self.pipe = self.calls, None, None
        rows = [self.picks[c["i"] % PICK_CALLS] for c in calls]
        x0 = torch.cat([self._x(c["i"])[torch.as_tensor(r, device=self.device)]
                        for c, r in zip(calls, rows)])
        lab = self.labels[np.concatenate(rows)].to(self.device)
        sc = self.scales[np.concatenate(rows)].to(self.device)
        # the program's states of the checked rows: (steps + 1, rows, h, w, z)
        states = torch.cat([torch.stack([s.float() for s in c["states"]]
                                        + [c["final"].permute(0, 2, 3, 1).float()])
                            for c in calls], dim=1)
        images = torch.cat([c["images"] for c in calls]).float()
        del calls
        Y.reference_mode()
        Pu, Pv = ({k: v.float() for k, v in P.items()} for P in self.weights())
        out = self.judge(Pu, Pv, x0, lab, sc, states, images)
        if control:
            sched, n = nets.schedule(self.config), self.traffic["steps"]
            images, st = ref.ddim_sample(Pu, self.ua, Pv, self.va, sched, x0, lab, sc, n,
                                         q=lowp.fp8)
            got = self.judge(Pu, Pv, x0, lab, sc, torch.stack(st), images)
            out.update({f"control.{k}": v for k, v in got.items()})
        return out

    @torch.no_grad()
    def judge(self, Pu, Pv, x0, lab, sc, states, images) -> dict:
        """start_gap, step_gap and decode_gap of one chain's states (steps +
        1, rows, h, w, z) and images, against the fp32 reference `Pu`, `Pv`."""
        n, R = states.shape[0] - 1, states.shape[1]
        ts = ref.ddim_timesteps(self.config["num_steps"], n)
        t = torch.tensor(ts, device=self.device).repeat_interleave(R)
        t_prev = torch.tensor(ts[1:] + [-1], device=self.device).repeat_interleave(R)
        x, target = states[:-1].flatten(0, 1), states[1:].flatten(0, 1)
        acp = ref.alpha_bars(nets.schedule(self.config))
        nxt = torch.cat([ref.ddim_update(Pu, self.ua, acp, x[i:i + BLOCK], t[i:i + BLOCK],
                                         t_prev[i:i + BLOCK], lab.repeat(n)[i:i + BLOCK],
                                         sc.repeat(n)[i:i + BLOCK])
                         for i in range(0, x.shape[0], BLOCK)])
        step = ((target - nxt).flatten(1).norm(dim=1) / (nxt - x).flatten(1).norm(dim=1))
        decoded = nets.vae_decode(Pv, self.va, states[-1])
        return {"start_gap": float((states[0] - x0).abs().max()),
                "step_gap": float(step.max()),
                "decode_gap": max(Y.rel_l2_rows(images, decoded))}
