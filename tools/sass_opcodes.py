"""Which machine instructions a kernel source compiles to, counted by opcode.

    python3 tools/sass_opcodes.py [threefry.cu]

Needs nvcc and cuobjdump (the CUDA toolkit); no GPU. Compiles one source of
gomel_tpu_torch/csrc with the flags the port builds with (ops/_cuda.py),
disassembles the object with ``cuobjdump -sass`` and prints, for each kernel
in it, how many instructions of each opcode it holds: the whole kernel, loop
bodies counted once. It shows which pipe a kernel's arithmetic goes to, for
example KP's round adds as IMAD.IADD (the FMA pipe) beside LOP3 and SHF (the
integer pipe), which is why KP's bound counts the card's whole dispatch rate
and not its int32 lanes alone (PERF.md). Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from gomel_tpu_torch.ops import _cuda  # noqa: E402

_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTRUCTION = re.compile(r"^\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)")


def opcodes(source: str) -> dict[str, collections.Counter]:
    """{kernel symbol: Counter of opcodes} of one csrc source."""
    nvcc = _cuda._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as work:
        obj = os.path.join(work, "kernel.o")
        flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([nvcc, *flags, "-c", "-o", obj, source], check=True)
        sass = subprocess.run([cuobjdump, "-sass", obj], check=True,
                              capture_output=True, text=True).stdout
    counts: dict[str, collections.Counter] = {}
    current = None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = counts.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSTRUCTION.match(line)
        if m and current is not None:
            current[m.group(1)] += 1
    return counts


def main(argv: list[str]) -> int:
    name = argv[1] if len(argv) > 1 else "threefry.cu"
    for kernel, count in opcodes(os.path.join(_cuda.CSRC_DIR, name)).items():
        total = sum(count.values())
        print(f"{name} {kernel}: {total} instructions")
        for op, n in count.most_common():
            print(f"  {n:5d}  {op}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
