"""The benchmark's plain reference (`benchmark/reference/`), loaded by path
as the package `bench_reference`, for the DiT tests: it imports nothing of
the port or of JAX."""

import importlib
import importlib.util
import sys
from pathlib import Path

REFERENCE = Path(__file__).resolve().parents[1] / "benchmark" / "reference"


def load(name: str = "dit"):
    """`benchmark/reference/<name>.py` as `bench_reference.<name>`."""
    if "bench_reference" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "bench_reference", REFERENCE / "__init__.py", submodule_search_locations=[str(REFERENCE)])
        module = importlib.util.module_from_spec(spec)
        sys.modules["bench_reference"] = module
        spec.loader.exec_module(module)
    return importlib.import_module(f"bench_reference.{name}")
