"""A run of each cell driven on the CPU at a small size, with the timed
path sound and then broken underneath, once for each fault the cell can
have: a sound run comes out correct, a broken one not.  The sound runs are
fp32 (the port's plain path), so the limits that the bf16 program meets on
the card hold by a wide margin; each fault departs by far more."""

import pytest

import tiny
from image_diffusion_torch.ops import schedule as S
from image_diffusion_torch.pipelines import diffusion as D
from image_diffusion_torch.training import diffusion_trainer as DT
from image_diffusion_torch.training import vae_trainer as VT

SAMPLE = "ldm-kl-lin.sample-ddim50-b256"
UNET = "ldm-kl-lin.train-b512"
VAE = "vae-kl-gan.train-b48"


@pytest.mark.parametrize("name", [SAMPLE, UNET, VAE])
def test_a_sound_run_is_correct(name):
    out = tiny.run(tiny.cell(name))
    assert out["correct"], out["compared"]
    assert out["failed"] == 0


def unchanged_sampler_step(monkeypatch):
    monkeypatch.setattr(S, "ddim_step", lambda sched, xt, eps, *a, **k: (xt, xt))


def altered_images(monkeypatch):
    sample = D.DiffusionPipeline._sample
    monkeypatch.setattr(D.DiffusionPipeline, "_sample",
                        lambda self, *a, **k: 0.5 * sample(self, *a, **k))


def unchanged_train_state(monkeypatch):
    # the optimizer takes the gradients' norm and applies nothing
    monkeypatch.setattr(DT.Optimizer, "step", lambda self: self.grad_norm(self.grads()))


def half_batch_unet(monkeypatch):
    make = DT.make_train_step

    def halved(*a, **k):
        step = make(*a, **k)

        def train_step(state, x, c, draws):
            h = x.shape[0] // 2
            return step(state, x[:h], c[:h], DT.Draws(*(d[:h] for d in draws)))

        return train_step

    monkeypatch.setattr(DT, "make_train_step", halved)


def half_batch_vae(monkeypatch):
    make = VT.make_vae_train_step

    def halved(*a, **k):
        step = make(*a, **k)

        def train_step(state, u8, draws, disc_active):
            h = u8.shape[0] // 2
            return step(state, u8[:h], VT.VAEDraws(*(d[:h] for d in draws)), disc_active)

        return train_step

    monkeypatch.setattr(VT, "make_vae_train_step", halved)


@pytest.mark.parametrize("name, fault", [
    (SAMPLE, unchanged_sampler_step), (SAMPLE, altered_images),
    (UNET, unchanged_train_state), (UNET, half_batch_unet),
    (VAE, unchanged_train_state), (VAE, half_batch_vae),
], ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_a_broken_run_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    out = tiny.run(tiny.cell(name))
    assert not out["correct"], out["compared"]
    assert out["failed"] >= 1
