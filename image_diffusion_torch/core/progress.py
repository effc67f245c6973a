"""Progress bars: tqdm when it is installed, imported at first use, else
the bare iterable."""

from __future__ import annotations

from typing import Iterable, Iterator


def progress(iterable: Iterable, total: int | None = None, desc: str | None = None) -> Iterator:
    try:
        from tqdm import tqdm
    except ImportError:
        return iter(iterable)
    return iter(tqdm(iterable, total=total, desc=desc, dynamic_ncols=True, leave=False))
