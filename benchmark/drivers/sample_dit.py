"""Closed-loop DiT sampling calls: one caller asks for a batch of
classifier-free guided class-conditional images, waits, and asks again, as
DiT's `sample_ddp.py` does on each card when it makes an FID-50K sample
set.

A unit is one `DiffusionPipeline.sample_batch` call of `images` images
whose class ids are drawn uniformly from the configuration's classes by
the run's seed and the call's index, at guidance `cfg_scale`, `steps` DDIM
steps at eta 0 (each one DiT call on 2 x `images` rows), then the KL-f8
decode of the latents over the latent scale.  Call i's initial latents are
drawn on the card from the seed and i.  The weights are drawn on the card
from the seed in the compute dtype, as a bundle serves them.

The check follows `sample.py`'s: each step is judged alone from the
program's own states.  Each call checks `checked_per_call` of its images,
rows drawn in set-up from the seed and the call's index: a hook on the DiT
copies those rows of the latents each call passes it, a wrapper on the
VAE's `decode` copies those rows of the latents it decodes, and the call
keeps those rows of its images.  After the window the reference
(`reference/dit.py`) takes the program's latent before each step to the
next and decodes the program's final latent; the numbers compared are
  * start_gap: the largest difference of the first state from the
    benchmark's initial latent (0: the call started where it was told);
  * step_gap: the worst step's |program's next latent - reference's| over
    |reference's next latent - the state it started from|;
  * decode_gap: the worst image's relative L2 distance to the reference's
    decode of the program's final latent.
The control is the fp8 reference in the program's place; the planted fault
"half_batch" is the reference with its guided calls on the conditional
half of their rows alone (guidance 1).
"""

from __future__ import annotations

import numpy as np
import torch

import yardstick as Y
from reference import dit as ref
from reference import lowp, nets

RATE = ("images_per_s", "images/s")
BLOCK = 64  # reference rows a DiT call (twice as many with the guidance's half)
PICK_CALLS = 64  # rows of the table of checked rows; call i takes row i mod PICK_CALLS


class Session:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from image_diffusion_torch.core.config import DiTArch, ScheduleConfig, VAEArch, _build
        from image_diffusion_torch.pipelines.diffusion import DiffusionPipeline

        Y.mark("program imported")

        if traffic["sampler"] != "ddim" or traffic["eta"] != 0:
            raise ValueError("the reference states the DDIM sampler at eta 0")
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.dtype = getattr(torch, config["compute_dtype"])
        self.da, self.va = ref.dit_arch(config), config["vae"]
        Pd, Pv = self.weights()
        nc = self.da["num_classes"]
        self.pipe = DiffusionPipeline(_build(VAEArch, self.va), Pv, _build(DiTArch, self.da), Pd,
                                      _build(ScheduleConfig, config), [str(i) for i in range(nc)],
                                      dtype=self.dtype, device=device)
        del Pd, Pv
        Y.mark("weights drawn, pipeline built")
        self.K = traffic["images"]
        self.scales = torch.full((self.K,), float(traffic["cfg_scale"]))
        r = ref.latent_res(self.va)
        self.latent = (r, r, self.da["in_channels"])
        # the checked rows of call i: row i mod PICK_CALLS of the table
        rng = np.random.default_rng(Y.derive_seed(seed, "check"))
        self.picks = np.stack([np.sort(rng.choice(self.K, traffic["checked_per_call"], replace=False))
                               for _ in range(PICK_CALLS)])
        self.pick_index = torch.as_tensor(self.picks, device=device)
        self.calls: list[dict] = [{"i": 0, "states": []}]  # the warm-up call's, dropped after it
        self.pipe.unet.register_forward_pre_hook(self._keep_state)
        decode = self.pipe.vae.decode

        def keep_final(z, **kwargs):
            call = self.calls[-1]
            call["final"] = z.index_select(0, self._rows(call["i"]))
            return decode(z, **kwargs)

        self.pipe.vae.decode = keep_final
        self._call(-1, traffic["warmup_steps"])
        self.calls.clear()
        Y.mark("warmed")
        self.min_units = 1

        n = traffic["steps"]
        fl = config["flops"]
        self.unit_items, self.unit_steps = self.K, n
        self.unit_flops = (n * 2 * self.K * fl["dit_forward_per_row"]
                           + self.K * fl["vae_decode_per_image"])
        # the DiT's d = 72 sites alone: the decoder's d = 512 site runs no
        # kernel of the port (plain route)
        site = Y.attention_forward(2 * self.K, ref.tokens(self.da), self.da["hidden_size"])
        self.unit_attention = [site] * (self.da["depth"] * n)

    def weights(self) -> tuple[dict, dict]:
        """The DiT's and the decoder's weights, drawn from the seed on the
        card in the compute dtype."""
        return (ref.dit_weights(self.da, Y.derive_seed(self.seed, "dit"), self.device, self.dtype),
                nets.make_weights(ref.ldm_decoder_leaves(self.va), Y.derive_seed(self.seed, "vae"),
                                  self.device, self.dtype))

    def _x(self, i: int) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed(Y.derive_seed(self.seed, "call", i))
        return torch.randn((self.K, *self.latent), generator=g, device=self.device)

    def _labels(self, i: int) -> torch.Tensor:
        g = torch.Generator().manual_seed(Y.derive_seed(self.seed, "labels", i))
        return torch.randint(self.da["num_classes"], (self.K,), generator=g)

    def _call(self, i: int, n_steps: int):
        t = self.traffic
        return self.pipe.sample_batch(self._labels(i), self.scales, self._x(i),
                                      sampler=t["sampler"], num_inference_steps=n_steps,
                                      eta=t["eta"])

    def _rows(self, i: int) -> torch.Tensor:
        return self.pick_index[i % PICK_CALLS]

    def _keep_state(self, module, args) -> None:
        call = self.calls[-1]
        call["states"].append(args[0].index_select(0, self._rows(call["i"])))

    def run_unit(self) -> None:
        i = len(self.calls)
        self.calls.append({"i": i, "states": []})
        images = self._call(i, self.traffic["steps"])
        self.calls[-1]["images"] = images.index_select(0, self._rows(i))

    def check(self, control: bool = False, fault: str | None = None) -> dict:
        """The compared numbers of the program (see the module doc); with
        `control` also those of the fp8 reference in its place
        ("control.<name>"); with `fault` "half_batch" those of the reference
        whose guided calls ran on half their rows, the conditional half
        alone (guidance 1), as a sampler that drops the unconditional half
        would ("fault.<name>")."""
        if fault not in (None, "half_batch"):
            raise ValueError(f"unknown fault {fault!r}")
        calls, self.calls, self.pipe = self.calls, None, None
        rows = [self.picks[c["i"] % PICK_CALLS] for c in calls]
        x0 = torch.cat([self._x(c["i"])[torch.as_tensor(r, device=self.device)]
                        for c, r in zip(calls, rows)])
        lab = torch.cat([self._labels(c["i"])[torch.as_tensor(r)]
                         for c, r in zip(calls, rows)]).to(self.device)
        sc = self.scales[np.concatenate(rows)].to(self.device)
        scale = self.va["latent_scale"]
        # the program's states of the checked rows: (steps + 1, rows, h, w, z),
        # the last taken back from what the decode was given
        states = torch.cat([torch.stack([s.float() for s in c["states"]]
                                        + [c["final"].float() * scale])
                            for c in calls], dim=1)
        images = torch.cat([c["images"] for c in calls]).float()
        del calls
        Y.reference_mode()
        Pd, Pv = ({k: v.float() for k, v in P.items()} for P in self.weights())
        out = self.judge(Pd, Pv, x0, lab, sc, states, images)
        if control:
            images, st = ref.ddim_sample(Pd, self.da, Pv, self.va, self.config, x0, lab, sc,
                                         self.traffic["steps"], q=lowp.fp8)
            got = self.judge(Pd, Pv, x0, lab, sc, torch.stack(st), images)
            out.update({f"control.{k}": v for k, v in got.items()})
        if fault:
            images, st = ref.ddim_sample(Pd, self.da, Pv, self.va, self.config, x0, lab,
                                         torch.ones_like(sc), self.traffic["steps"])
            got = self.judge(Pd, Pv, x0, lab, sc, torch.stack(st), images)
            out.update({f"fault.{k}": v for k, v in got.items()})
        return out

    @torch.no_grad()
    def judge(self, Pd, Pv, x0, lab, sc, states, images) -> dict:
        """start_gap, step_gap and decode_gap of one chain's states (steps +
        1, rows, h, w, z) and images, against the fp32 reference `Pd`, `Pv`."""
        n, R = states.shape[0] - 1, states.shape[1]
        ts = ref.ddim_timesteps(self.config["num_steps"], n)
        t = torch.tensor(ts, device=self.device).repeat_interleave(R)
        t_prev = torch.tensor(ts[1:] + [-1], device=self.device).repeat_interleave(R)
        x, target = states[:-1].flatten(0, 1), states[1:].flatten(0, 1)
        acp = ref.alpha_bars(self.config)
        nxt = torch.cat([ref.ddim_update(Pd, self.da, acp, x[i:i + BLOCK], t[i:i + BLOCK],
                                         t_prev[i:i + BLOCK], lab.repeat(n)[i:i + BLOCK],
                                         sc.repeat(n)[i:i + BLOCK])
                         for i in range(0, x.shape[0], BLOCK)])
        step = ((target - nxt).flatten(1).norm(dim=1) / (nxt - x).flatten(1).norm(dim=1))
        decoded = ref.ldm_decode(Pv, self.va, states[-1] / self.va["latent_scale"])
        return {"start_gap": float((states[0] - x0).abs().max()),
                "step_gap": float(step.max()),
                "decode_gap": max(Y.rel_l2_rows(images, decoded))}

