"""Progress reporting (port of the JAX package's ``util/progress.py``): tqdm
when it is installed and stderr is a tty, a silent pass-through otherwise."""

from __future__ import annotations

import sys
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")


def progress(it: Iterable[T], desc: str = "", silent: bool = False) -> Iterator[T]:
    if silent or not sys.stderr.isatty():
        yield from it
        return
    try:
        from tqdm import tqdm

        yield from tqdm(it, desc=desc, leave=False)
    except ImportError:
        yield from it
