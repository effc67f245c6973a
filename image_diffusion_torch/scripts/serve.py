"""Micro-batching HTTP inference server over the port's sampler, the
counterpart of scripts/serve.py, with the same API and status codes.

    python -m image_diffusion_torch.scripts.serve checkpoints/bundle.ckpt --port 8765 \
        --batch-size 8 --sampler dpm --steps 20

API:
  GET  /healthz -> {"ok": true, "compiled": true}  ("compiled": warmed up)
  GET  /info    -> classes, sampler, steps, batch_size, image_size, stats
  POST /sample  -> image/png
      JSON body: {"class": 0 | "a hot place", "cfg_scale": 3.0, "seed": 1}
  400 for a malformed body or an unknown class, 404 for other paths, 500
  when sampling fails.

One worker thread gathers up to `--batch-size` requests within
`--linger-ms` of the first and runs them as one batch, padded to the fixed
size (pad rows: seed 0, class 0, scale 1.0), so cuBLAS and cuDNN always
see one shape.  A finisher thread copies each batch's uint8 images to the
host, encodes the PNGs and answers; under load the worker queues batch
k+1's kernels meanwhile.  At most two finished batches wait for it.

Determinism: each row's initial latent and its step noise (ddpm; ddim with
eta > 0) come from one generator on the card seeded with the request's
seed, drawn in sequence (`DiffusionPipeline.sample_batch(row_generators=)`),
so a request's image depends only on its (class, cfg_scale, seed), not on
what it was batched with or its slot.  The streams are torch's, so a seed
gives other images than the JAX package's server.

Runs on the CUDA card unless `--device cpu` is given.  Not ported yet:
`--data-parallel` (multi-GPU serving).
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..core.cli import add_device_argument, setup_logging

log = logging.getLogger("serve")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("model", type=str, help="Path to a Diffusion bundle checkpoint.")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--batch-size", type=int, default=8,
                   help="Fixed batch size; requests are micro-batched up to this.")
    p.add_argument("--linger-ms", type=float, default=25.0,
                   help="How long to wait for co-batchable requests after the first.")
    p.add_argument("--sampler", choices=["ddpm", "ddim", "dpm"], default="dpm")
    p.add_argument("--steps", type=int, default=20,
                   help="Inference steps for ddim/dpm (ddpm always runs the "
                        "full training schedule).")
    p.add_argument("--eta", type=float, default=0.0, help="DDIM stochasticity.")
    add_device_argument(p)
    return p.parse_args(argv)


class Engine:
    """Owns the pipeline, the worker thread that micro-batches requests
    and the finisher thread that answers them."""

    def __init__(self, args):
        from ..pipelines import DiffusionPipeline

        self.args = args
        self.pipe = DiffusionPipeline.from_checkpoint(args.model, device=args.device)
        self.device = self.pipe.device
        self.classes = self.pipe.classes
        self.B = args.batch_size
        self.sampler = args.sampler
        self.requests: queue.Queue[tuple[dict, queue.Queue]] = queue.Queue()
        self.compiled = False
        self._worker_error: BaseException | None = None
        self.stats = {"requests": 0, "batches": 0}
        self._finish_q: queue.Queue[tuple[torch.Tensor, list]] = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self._fin_thread = threading.Thread(target=self._finisher, daemon=True)
        self._fin_thread.start()

    # ------------------------------------------------------------ sampling
    def _row_generators(self, seeds) -> list[torch.Generator]:
        """One generator per row on the pipeline's device, seeded with the
        row's request seed."""
        return [torch.Generator(device=self.device).manual_seed(int(s)) for s in seeds]

    def _run(self, seeds, labels, scales) -> torch.Tensor:
        """One padded batch -> (B, H, W, 3) uint8 images on the device,
        queued but not waited for."""
        with torch.inference_mode():
            gens = self._row_generators(seeds)
            x_init = torch.stack([torch.randn(self.pipe.latent_shape, generator=g,
                                              device=self.device) for g in gens])
            return self.pipe.sample_batch(
                labels, scales, x_init, sampler=self.sampler,
                num_inference_steps=self.args.steps, eta=float(self.args.eta),
                row_generators=gens, output="uint8")

    @property
    def steps(self) -> int:
        return self.pipe.sched.num_steps if self.sampler == "ddpm" else self.args.steps

    def warmup(self):
        t0 = time.time()
        self._run([0] * self.B, [0] * self.B, [3.0] * self.B).cpu()  # waits for the device
        self.compiled = True
        log.info("warmed up batch=%d %s sampler in %.1fs", self.B, self.sampler,
                 time.time() - t0)

    # ------------------------------------------------------------ batching
    def submit(self, req: dict) -> bytes:
        """Called from HTTP handler threads; blocks until the image is ready.

        Polls the threads' liveness while waiting: a batch's exception
        comes back through the reply queue, but a thread that dies (a
        BaseException, or a fault between get() and put()) would leave an
        unbounded get() hanging every handler."""
        reply: queue.Queue[object] = queue.Queue(1)
        self.requests.put((req, reply))
        while True:
            try:
                result = reply.get(timeout=1.0)
                break
            except queue.Empty:
                if not (self._thread.is_alive() and self._fin_thread.is_alive()):
                    raise RuntimeError(f"inference worker died: {self._worker_error!r}")
        if isinstance(result, Exception):
            raise result
        return result

    def _worker(self):
        try:
            self._worker_loop()
        except BaseException as e:  # liveness flag for submit()'s poll
            self._worker_error = e
            raise

    def _worker_loop(self):
        while True:
            batch = [self.requests.get()]  # block for the first request
            deadline = time.time() + self.args.linger_ms / 1e3
            while len(batch) < self.B:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(self.requests.get(timeout=remaining))
                except queue.Empty:
                    break
            n = len(batch)
            pad = self.B - n
            seeds = [r["seed"] for r, _ in batch] + [0] * pad
            labels = [r["label"] for r, _ in batch] + [0] * pad
            scales = [r["cfg_scale"] for r, _ in batch] + [1.0] * pad
            try:
                imgs = self._run(seeds, labels, scales)  # queued on the device
            except Exception as e:  # surface the error to every waiter
                for _, reply in batch:
                    reply.put(e)
            else:
                # batch holds only real requests; the padding lives in the lists
                self._finish_q.put((imgs, batch))
            self.stats["requests"] += n
            self.stats["batches"] += 1

    def _finisher(self):
        try:
            while True:
                imgs, batch = self._finish_q.get()
                answered = 0  # rows already replied with a PNG
                try:
                    arr = imgs.cpu().numpy()  # waits for the device
                    for i, (_, reply) in enumerate(batch):
                        reply.put(self._to_png(arr[i]))
                        answered = i + 1
                except Exception as e:
                    # launch faults surface at the copy; a PNG failure midway
                    # reaches only the rows not yet answered, whose reply
                    # queues are empty (a full one would stall the finisher)
                    for _, reply in batch[answered:]:
                        reply.put(e)
        except BaseException as e:  # liveness flag for submit()'s poll
            self._worker_error = e
            raise

    @staticmethod
    def _to_png(arr) -> bytes:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue()

    def resolve_class(self, c) -> int:
        if isinstance(c, int) and not isinstance(c, bool):
            if not 0 <= c < len(self.classes):
                raise ValueError(f"class index {c} out of range")
            return c
        if c in self.classes:
            return self.classes.index(c)
        raise ValueError(f"unknown class {c!r}; classes: {self.classes}")


def make_handler(engine: Engine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging
            log.debug(fmt, *args)

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "compiled": engine.compiled})
            elif self.path == "/info":
                self._json(200, {
                    "classes": engine.classes,
                    "sampler": engine.sampler,
                    "steps": engine.steps,
                    "batch_size": engine.B,
                    "image_size": engine.pipe.vae_arch.init_resolution,
                    "stats": engine.stats,
                })
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/sample":
                return self._json(404, {"error": "not found"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                req = {
                    "label": engine.resolve_class(payload.get("class", 0)),
                    "cfg_scale": float(payload.get("cfg_scale", 3.0)),
                    "seed": int(payload.get("seed", 0)),
                }
                if not -2 ** 63 <= req["seed"] < 2 ** 64:
                    # torch.Generator.manual_seed's range: beyond it the
                    # worker would raise and fail the whole batch
                    raise ValueError(f"seed {req['seed']} is outside [-2**63, 2**64)")
            except (ValueError, TypeError, AttributeError, json.JSONDecodeError) as e:
                # TypeError: int(None)/float(None); AttributeError: a JSON
                # array body has no .get -- all malformed requests, all 400
                return self._json(400, {"error": str(e)})
            try:
                png = engine.submit(req)
            except Exception as e:
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(png)))
            self.end_headers()
            self.wfile.write(png)

    return Handler


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # a burst of concurrent clients larger than the default backlog (5)
    # gets connection-reset at accept(); size for bursty micro-batching
    request_queue_size = 128


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    engine = Engine(args)
    server = _Server((args.host, args.port), make_handler(engine))
    log.info("serving %s on http://%s:%d (classes: %s)", args.model, args.host, args.port,
             ", ".join(engine.classes))
    # warm up before /healthz says so; the socket is already bound, so
    # clients can poll it meanwhile
    threading.Thread(target=engine.warmup, daemon=True).start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
