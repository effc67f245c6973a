"""Plumbing the port's command-line entry points share: the log format of
the JAX package's CLIs, and the device argument.  The JAX package's
`force_cpu` has no counterpart: `--device cpu` does its job."""

from __future__ import annotations

import argparse
import logging


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s : %(message)s",
        datefmt="[%H:%M:%S]",
    )


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu (the kernels' plain versions).")
