"""Which machine instructions a kernel source compiles to, counted by opcode.

    python3 tools/sass_opcodes.py [threefry.cu]

Needs nvcc and cuobjdump (the CUDA toolkit); no GPU. Compiles one source of
gomel_tpu_torch/csrc with the flags the port builds with (ops/_cuda.py),
disassembles the object with ``cuobjdump -sass`` and prints, for each kernel
in it, how many instructions of each opcode it holds (the whole kernel, loop
bodies counted once) and their sum by pipe (``pipes``). It shows which pipe
a kernel's arithmetic goes to, for example KP's rotations as IMAD.WIDE.U32
(the FMA pipe) beside LOP3 and IADD3 (the integer pipe), which is why KP's
bound counts the card's whole dispatch rate and not its int32 lanes alone
(PERF.md). A path outside csrc compiles with csrc on the include path
(tools/profile_prng.py's variants). Imports nothing of JAX.
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


# the pipe of each opcode family as this tool counts them: "fma" the FP32
# pipe, which also runs IMAD; "int" the integer pipe of half its width
# (IADD3, LOP3, SHF, compares, selects); the rest (memory, control, the
# uniform datapath, and VIADD, whose pipe this tool does not know) "other"
_FMA = ("IMAD", "FFMA", "FADD", "FMUL", "HFMA2")
_INT = ("IADD3", "LOP3", "SHF", "ISETP", "LEA", "SEL", "PRMT", "IMNMX",
        "FMNMX", "FSEL", "FSETP", "POPC", "FLO", "BREV", "IABS")


def pipe(op: str) -> str:
    """"fma", "int" or "other" for one opcode (with its modifiers)."""
    base = op.split(".")[0]
    if base in _FMA:
        return "fma"
    if base in _INT:
        return "int"
    return "other"


def pipes(count: collections.Counter) -> dict[str, int]:
    """Instructions of one kernel summed by :func:`pipe`."""
    out = {"fma": 0, "int": 0, "other": 0}
    for op, n in count.items():
        out[pipe(op)] += n
    return out


def opcodes(source: str) -> dict[str, collections.Counter]:
    """{kernel symbol: Counter of opcodes} of one source (csrc's own, or a
    copy elsewhere that includes csrc's headers)."""
    nvcc = _cuda._nvcc()
    with tempfile.TemporaryDirectory() as work:
        obj = os.path.join(work, "kernel.o")
        flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
        subprocess.run([nvcc, *flags, "-I", _cuda.CSRC_DIR, "-c", "-o", obj,
                        source], check=True)
        return binary_opcodes(obj)


def binary_opcodes(binary: str) -> dict[str, collections.Counter]:
    """{kernel symbol: Counter of opcodes} of a built object or shared
    library."""
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", binary], check=True,
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
        print(f"{name} {kernel}: {total} instructions, by pipe "
              f"{pipes(count)}")
        for op, n in count.most_common():
            print(f"  {n:5d}  {op}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
