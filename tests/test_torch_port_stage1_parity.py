"""The two packages' stage 1 over whole runs, and the full-width VAE.

  * `test_stage1_trajectory_matches_jax_over_steps`: 30 fp32 steps of the
    step functions from one state on the same batches and draws;
  * `test_trainers_keep_together_through_code_revival`: both packages' real
    `VAETrainer.train()` on the e2e run's data at tiny widths from one state
    and one stream of draws (`torch_port_stage1_harness.run_pair`), with a
    codebook gamma of 0.9 so that the codes the first batch leaves dead come
    back into the latents' range within the run;
  * `test_full_width_vae_matches_jax`: the shipped-width KL and VQ VAEs
    from one JAX state, encode and decode at fp32;
  * slow: the harness's modes (a) and (b) over the e2e run's 500 steps at
    the reduced widths `WIDE` (`pytest -m slow
    tests/test_torch_port_stage1_parity.py`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_stage1_harness as harness
from image_diffusion_tpu.core.config import VAEArch as JVAEArch
from image_diffusion_tpu.models import build_vae as jbuild_vae
from image_diffusion_tpu.training.diffusion_trainer import make_optimizer
from image_diffusion_tpu.training.vae_trainer import VAETrainState as JState
from image_diffusion_tpu.training.vae_trainer import make_vae_train_step as jmake_step
from image_diffusion_torch.compat.from_jax import vae_flax_variables, vae_state_dict
from image_diffusion_torch.core.config import VAEArch
from image_diffusion_torch.models import build_vae
from image_diffusion_torch.training.diffusion_trainer import Optimizer
from image_diffusion_torch.training.vae_trainer import make_vae_train_step
from test_torch_port_vae_training import (RNG, codebook_tree, configs, jax_draws, leaves, models,
                                          port_state, rel_l2)

VQ = dict(bottleneck="vq", codebook_size=1024, codebook_beta=0.25, codebook_gamma=0.99)


@pytest.mark.parametrize("bottleneck", ["kl", "vq"])
def test_stage1_trajectory_matches_jax_over_steps(bottleneck):
    """30 fp32 steps of the end-to-end run's stage 1 (lr 1e-4 after a
    warmup, here of 10 steps, clip 1, no discriminator, no LPIPS; prior
    weight 5e-6 for KL, 1 for VQ) from one state, on the same batches and
    draws: every step's losses at rtol 2e-4, and after the last step the
    parameter updates at relative L2 1e-3 (the one-step bar; read 1.3e-4
    at 30 and 60 steps) and the VQ codebook at relative L2 1e-5 (read
    3e-7).  The two trainers keep together over many steps, not just one."""
    vae, disc, _, vae_vars, disc_vars = models(bottleneck)
    over = dict(learning_rate=1e-4, warmup_steps=10, disc_start=10**9,
                prior_weight=1.0 if bottleneck == "vq" else 5e-6)
    jc, tc = configs("/nonexistent", bottleneck, **over)
    vae_tx = make_optimizer(jc.train.learning_rate, jc.train.warmup_steps, jc.train.clip_grad)
    disc_tx = make_optimizer(jc.train.learning_rate, 0, jc.train.clip_grad)
    jstate = JState(step=jnp.zeros((), jnp.int32), vae_params=vae_vars["params"],
                    vae_opt=vae_tx.init(vae_vars["params"]), codebook=vae_vars.get("codebook"),
                    disc_params=disc_vars["params"], disc_stats=disc_vars["batch_stats"],
                    disc_opt=disc_tx.init(disc_vars["params"]))
    jstep = jmake_step(vae, disc, jc, None, vae_tx, disc_tx)
    state = port_state(bottleneck)
    state.vae_opt = Optimizer(state.vae.parameters(), 1e-4, 10, 1.0)
    step = make_vae_train_step(tc, None)
    rng = np.random.default_rng(0)
    for i in range(30):
        x = rng.integers(0, 256, (4, 16, 16, 3)).astype(np.uint8)
        jstate, ref = jstep(jstate, x, RNG, disc_active=False)
        got = step(state, torch.from_numpy(x), jax_draws(i), False)
        for k in ("vae/recon_loss", "vae/prior_loss"):
            assert float(got[k]) == pytest.approx(float(ref[k]), rel=2e-4, abs=1e-7), (i, k)
    names = [n for n, _ in state.vae.named_parameters()]
    mine = leaves(vae_flax_variables(dict(zip(names, state.vae_opt.params)))["params"])
    theirs, start = leaves(jstate.vae_params), leaves(vae_vars["params"])
    got = np.concatenate([(a - b).ravel() for a, b in zip(mine, start)])
    ref = np.concatenate([(a - b).ravel() for a, b in zip(theirs, start)])
    assert rel_l2(got, ref) < 1e-3
    if bottleneck == "vq":
        for a, b in zip(leaves(codebook_tree(state.vae)), leaves(jstate.codebook)):
            assert rel_l2(a, b) < 1e-5


# the tier-1 run: tiny widths, one epoch of 40 steps of 16 on the e2e run's
# 32x32 data, gamma 0.9 (a dead code's embedding shrinks by 0.9 a step, so
# the codes the first batch leaves dead come back from step ~11), a trace
# row every step
REVIVAL = harness.Setup("vq", arch=dict(harness.TINY), n_per_class=214, batch=16, steps=40,
                        gamma=0.9, every=1, dev_per_class=16)
_PAIR = {}


def revival_pair():
    """`harness.run_pair(REVIVAL)` with its parting step, once, on one torch
    thread (the suite's workers share the cores)."""
    if not _PAIR:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            _PAIR.update(harness.run_pair(REVIVAL, controls=0, flips=True))
        finally:
            torch.set_num_threads(threads)
    return _PAIR


@pytest.mark.parametrize("what", ["before", "parting", "after"])
def test_trainers_keep_together_through_code_revival(what):
    """Both `VAETrainer.train()`s from one state on JAX's permutation,
    flips and noise, fp32 (`harness.run_pair`), through the codebook's
    revival: the live codes grow tenfold and more over the run (read 8 to
    139).  before: every step before the two codebooks part (cluster sizes
    at relative L2 1e-5) holds the one-step bars: losses at rtol 2e-4,
    parameter updates at relative L2 1e-3, embeddings, ema_w and cluster
    sizes at 1e-5, equal live and picked code counts; they part only once
    dead codes have come back (read: step 33 of 40, at 134 live codes).
    parting: at that step at most 2 of the 1,024 tokens take another code
    (read: 1), each package's code is the float64 nearest of its own
    token, and the token is a near-tie: its float64 gap between the two
    nearest codes is below 1e-3 of the median token's (read 9.4e-7 against
    3.5e-3), so the fp32 difference of the two encoders' tokens (read
    8.9e-5 at most) decides it.  after: the run ends alike: the dev probe's
    reconstruction loss at rtol 1e-4 (read 5.4e-5), utilization within 2 of
    1,024 codes (read 0) and perplexity at rtol 2e-2 (read 4.9e-4), and
    every step's live codes within 2 (read 0) and recon loss at rtol 2e-3
    (read 1.6e-4)."""
    res = revival_pair()
    jr, tr, parting = res["jax"], res["torch"], res["parting"]
    assert [r["step"] for r in jr["rows"]] == [r["step"] for r in tr["rows"]] == list(range(1, 41))
    assert jr["rows"][-1]["live_codes"] >= 10 * jr["rows"][0]["live_codes"]
    assert parting is not None and jr["rows"][parting - 1]["live_codes"] > jr["rows"][0]["live_codes"]
    if what == "before":
        for j, t in zip(jr["rows"][:parting - 1], tr["rows"]):
            where = f"step {j['step']}"
            for k in ("recon", "prior"):
                assert t[k] == pytest.approx(j[k], rel=2e-4, abs=1e-7), (where, k)
            assert t["update_rel"] < 1e-3, where
            for k in ("embeddings_rel", "ema_w_rel", "ema_cluster_size_rel"):
                assert t[k] < 1e-5, (where, k)
            assert (t["live_codes"], t["probe_codes"]) == (j["live_codes"], j["probe_codes"]), where
    elif what == "parting":
        f = res["flips"]
        assert f["tokens"] == 1024 and 1 <= f["differ"] <= 2 and f["own"], f
        assert max(f["gap"]) < 1e-3 * f["median_gap"], f
    else:
        assert tr["end"]["recon_loss"] == pytest.approx(jr["end"]["recon_loss"], rel=1e-4)
        assert abs(tr["end"]["utilization"] - jr["end"]["utilization"]) <= 2 / 1024 + 1e-9
        assert tr["end"]["dev_perplexity"] == pytest.approx(jr["end"]["dev_perplexity"], rel=2e-2)
        for j, t in zip(jr["rows"], tr["rows"]):
            assert abs(t["live_codes"] - j["live_codes"]) <= 2, j["step"]
            assert t["recon"] == pytest.approx(j["recon"], rel=2e-3), j["step"]


@pytest.mark.parametrize("bottleneck", ["kl", "vq"])
def test_full_width_vae_matches_jax(bottleneck):
    """The shipped widths (`VAEArch()`: channels (128, 256, 384), 2 res
    blocks a level, the d=384 mid-block attention), the VQ one with the
    shipped codebook, from one JAX initial state at fp32, batch 1 of the
    e2e run's images at 32x32 (the layers and weights of 128x128, the
    mid-block attention over 64 tokens): the encoder's raw map (KL: mean
    || log_var), the VQ codes, and the decode of the posterior mean or of
    the quantized codes at atol 2e-4 (the fp32 layers' bar)."""
    arch = dict(VQ) if bottleneck == "vq" else {}
    jvae = jbuild_vae(JVAEArch(**arch), dtype=jnp.float32)
    x = harness.e2e.make_dataset(1, size=32)[0][1:2]
    x01 = (x.astype(np.float32) / 255.0 - 0.5) / 0.5
    variables = jax.jit(lambda: jvae.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)}, x01))()

    @jax.jit
    def jax_forward(v, x):
        raw = jvae.apply(v, x, method=lambda m, y: m.encoder(y))
        z, _, _ = jvae.apply(v, x, sample=False, method="encode")
        if bottleneck == "kl":
            z = z[..., :3]
        return raw, z, jvae.apply(v, z, method="decode")

    raw_ref, z_ref, out_ref = (np.asarray(a) for a in jax_forward(variables, x01))
    vae = build_vae(VAEArch(**arch), torch.float32, "cpu")
    vae.load_state_dict(vae_state_dict(jax.tree.map(np.asarray, variables)))
    with torch.no_grad():
        xt = torch.from_numpy(x01)
        raw = vae._encoder(xt)
        z = vae.encode(xt)[0]
        z = z[..., :3] if bottleneck == "kl" else z
        out = vae.decode(z)
    np.testing.assert_allclose(raw.numpy(), raw_ref, atol=2e-4)
    if bottleneck == "vq":
        np.testing.assert_array_equal(vae.codebook.indices(raw).numpy(),
                                      np.asarray(jax.jit(lambda v, x: jvae.apply(
                                          v, x, method="encode_indices"))(variables, x01)))
    np.testing.assert_allclose(z.numpy(), z_ref, atol=2e-4)
    np.testing.assert_allclose(out.numpy(), out_ref, atol=2e-4)


def test_probe_traces_a_reduced_run(capsys, tmp_path):
    """`stage1_probe` on the CPU at a reduced width with `--trace-every`:
    a trace line every 2 of the 6 steps (the VQ keys of `trace_numbers`,
    finite), then the run's line with the dev loss and the VQ numbers;
    `--cpu-draws` and `--init-seed` take the same path on any device, and
    `--init-vae` with a model file of the port's own draw from generator
    seed 1 runs the very run `--init-seed 1` does."""
    import re

    from image_diffusion_torch.models.io import save_vae
    from image_diffusion_torch.tools import stage1_probe

    common = ["--bottleneck", "vq", "--device", "cpu", "--channels", "32", "32", "32",
              "--image-size", "16", "--n-per-class", "16", "--vae-steps", "6", "--fid-images",
              "48", "--batch", "16", "--no-fid", "--trace-every", "2", "--cpu-draws"]
    arch = harness.e2e.stage1_config(VAEArch(channels=(32, 32, 32), init_resolution=16), "vq",
                                     16, 1, "unused").arch
    init = str(tmp_path / "init.ckpt")
    save_vae(init, arch, build_vae(arch, torch.float32, "cpu",
                                   torch.Generator().manual_seed(1)).state_dict())
    runs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    try:
        for extra in (["--init-seed", "1"], ["--init-vae", init]):
            stage1_probe.main(common + extra)
            runs.append([re.sub(r"in [0-9.]+ s", "", ln) for ln in
                         capsys.readouterr().out.splitlines() if ln.startswith("vq-bf16-seed0")])
    finally:
        torch.set_num_threads(threads)
    lines = runs[0]
    traces = [dict(kv.split("=") for kv in ln.split(" trace ")[1].split()) for ln in lines[:-1]]
    assert [t["step"] for t in traces] == ["2", "4", "6"]
    for t in traces:
        assert set(t) == {"step", "recon", "prior", "latent_rms", "latent_max", "probe_codes",
                          "live_codes", "dead_norm_q10", "dead_norm_q50", "dead_norm_q90"}
        assert all(np.isfinite(float(v)) for v in t.values())
    assert "6 steps" in lines[-1] and "utilization" in lines[-1]
    assert runs[1] == lines


# ------------------------------------------------ the whole run (slow)


# the slow VQ test's shared states: JAX's initial state and 7 moved by one ulp
STATES = 8


@pytest.mark.slow
@pytest.mark.parametrize("bottleneck", ["kl", "vq"])
def test_mode_a_over_the_whole_run(bottleneck):
    """Mode (a) over the e2e run's 500 steps at `harness.WIDE`: JAX and the
    port from one state on one stream, and the same from states moved by
    one ulp.

    KL (one control, the port moved by one ulp, in process): on every
    traced quantity (the step's recon loss, the latents' RMS, the
    posterior std) and the end recon loss the port's largest departure
    from JAX is at most three times the control's (read at most 1.1x),
    and the distance of the parameter updates to JAX's below twice the
    control's at every row (read 1.3e-3 to 2.7e-2 against 1.5e-3 to
    2.8e-2).

    VQ (the paired rule, `harness.paired`): the port and JAX each from
    `STATES` shared states (JAX's initial state and, `perturb` seeds 1-7,
    that state moved by one ulp), each run a process on its own 2 cores.
    A run of a VQ codebook parts from its twin at its first near-tie code
    flip and then goes its own chaotic way, so one pair's departure is one
    draw of the rounding, and a bar on one draw (`harness.verdict`) is met
    or not by chance.  Over the states, a fault of the port moves its gain
    over JAX one way; rounding moves it both ways.  The test fails if on
    any of `harness.PAIR_KEYS` (the mean live codes over steps 100-300,
    the end utilization, perplexity and recon loss) every state's gain
    has one sign (chance 2 / 2**8 a key under rounding).  The distance of
    the port's parameter updates to JAX's stays below twice control 1's
    largest (read before: 0.178 against 0.162; two unrelated runs ~1.4).
    Read once (3,648 s on 4 workers of 2 cores): the live-code gains
    +25.6, -18.2, +6.7, +9.1, -21.7, +1.7, -22.8, +4.7, the end
    utilization's -0.084 to +0.052, perplexity's -33.3 to +29.2 and recon
    loss's -1.9e-3 to +1.7e-3: both signs on every key.  On the same runs
    the one-draw rule read the port's live codes 42 inside the 7 port
    controls' largest, 64; against 4 port and 2 JAX controls, whose
    largest read 31, the same 42 was outside."""
    vq = bottleneck == "vq"
    res = harness.run_pair(harness.Setup(bottleneck), controls=STATES - 1 if vq else 1,
                           jax_twins=STATES - 1 if vq else 0, workers=4 if vq else 0)
    print(harness.table(res))  # the readings, shown with -rP
    if vq:
        assert not res["paired"]["consistent"], res["paired"]
    else:
        deps = res["departures"]
        for k, port in deps["torch"].items():
            assert port <= 3 * deps["control1"][k], (k, port, deps["control1"][k])
    control = res["controls"][0]["rows"]
    top = max(c["update_rel"] for c in control)
    for t, c in zip(res["torch"]["rows"], control):
        assert t["update_rel"] <= 2 * (top if vq else c["update_rel"]), t["step"]


@pytest.mark.slow
@pytest.mark.parametrize("bottleneck", ["kl", "vq"])
def test_mode_b_spreads(bottleneck):
    """Mode (b) at seeds 0-3 at `harness.WIDE`: JAX with its own draws, the
    port with its own draws from its own initial draw and (VQ) from JAX's.
    The seed ranges of the dev probe's reconstruction loss overlap, from
    either initial draw (read VQ 0.1747-0.1794 for JAX, 0.1748-0.1765 and
    0.1748-0.1778 for the port).  VQ utilization follows the initial draw
    (the port's own: 0.4385-0.4717 against JAX's 0.6064-0.7422): from JAX's
    initial state the port's lowest is not below JAX's lowest by more than
    the history checker's 0.1 (read 0.75)."""
    inits = [False, True] if bottleneck == "vq" else [False]
    ends = {p: [] for p in ["jax"] + [f"torch_jax_init_{i}" for i in inits]}
    for seed in range(4):
        s = dataclasses.replace(harness.Setup(bottleneck), seed=seed)
        ends["jax"].append(harness.run_jax(s)["end"])
        for i in inits:
            ends[f"torch_jax_init_{i}"].append(harness.run_port(s, jax_init=i)["end"])
    lo = {p: min(e["recon_loss"] for e in v) for p, v in ends.items()}
    hi = {p: max(e["recon_loss"] for e in v) for p, v in ends.items()}
    for p in ends:
        assert lo[p] <= hi["jax"] and lo["jax"] <= hi[p], (p, lo, hi)
    if bottleneck == "vq":
        low = {p: min(e["utilization"] for e in v) for p, v in ends.items()}
        assert low["torch_jax_init_True"] >= low["jax"] - 0.1, low
