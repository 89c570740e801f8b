"""The program's own launch counters: every ``Kernel`` object of the port
(``ops/_cuda.py``, ``launches``, one added per launch by its wrapper), the
``xla`` route's tally among them, found in the port's loaded modules."""
from __future__ import annotations

import sys


def kernels() -> list:
    cuda = sys.modules.get("gomel_tpu_torch.ops._cuda")
    if cuda is None:
        return []
    found = {}
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == "gomel_tpu_torch"
                               or name.startswith("gomel_tpu_torch.")):
            continue
        for value in list(vars(mod).values()):
            if isinstance(value, cuda.Kernel):
                found[id(value)] = value
    return list(found.values())


# tallies that count a launch another counter also counts (ops/quantize.py:
# KA's zero-stuff form beside KA's own counter)
SHADOW = ("pcm16_ingest zero-stuff",)


def launches() -> dict[str, int]:
    """Each counter's launches so far, by its name."""
    out: dict[str, int] = {}
    for k in kernels():
        if k.name not in SHADOW:
            out[k.name] = out.get(k.name, 0) + k.launches
    return out


def delta(before: dict[str, int], after: dict[str, int]) -> dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}
