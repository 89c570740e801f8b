"""The two readings each limit of a cell's check is set between.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 --seconds 2

On the card, in one process: the program's numbers, one short run of the
cell's traffic a seed (``--seeds`` seeds from ``--first-seed``), whose
largest is the lower reading; then the control's, the bf16 reference put
in the program's place on the same inputs and as many calls as a run
compares (``--control-seeds`` further seeds), whose smallest is the upper
reading. Prints both and writes them as JSON to ``--out``.
"""
import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_numbers(ent, clock, calls: int) -> dict:
    """The check's numbers with the bf16 reference in the program's place,
    on the entry's first ``calls`` calls (driven one at a time)."""
    from portbench.harness import loop
    done = []
    loop.run(ent.submit, clock, 1, math.inf, loop.Spans(), max_calls=calls,
             on_complete=done.append)
    ent.release()
    return ent.check([ent.control(c) for c in done])


def control_at(workload: str, seed: int) -> dict:
    """``control_numbers`` of the cell's entry on card 0, at its size."""
    import torch

    from portbench.harness import loop
    from portbench.harness.manifest import Manifest
    man = Manifest()
    cell = man.workload(workload)
    tr = man.traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    ent = man.entry(tr["entry"]).Entry(man.config(cell["config"]), tr,
                                          seed, device)
    clock = loop.CudaClock(device, getattr(ent, "devices", [device]))
    return control_numbers(ent, clock, tr["check"]["sample_calls"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_017)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="calibrate.json")
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import cell
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    seeds = [args.first_seed + 7919 * k for k in range(args.seeds)]
    program = {}
    for s in seeds:
        r = cell.run(args.workload, s, args.seconds, False)
        program[s] = {k: c["value"] for k, c in r["checks"].items()}
        print(f"program seed {s}: {program[s]} correct {r['correct']} "
              f"calls {r['attempted']}", flush=True)
    control = {}
    for k in range(args.control_seeds):
        s = args.first_seed + 104729 * (k + 1)
        control[s] = control_at(args.workload, s)
        print(f"control seed {s}: {control[s]}", flush=True)
    names = sorted(next(iter(program.values())))
    summary = {}
    for n in names:
        lower = max(v[n] for v in program.values())
        upper = min(v[n] for v in control.values()) if control else math.nan
        summary[n] = {"lower": lower, "upper": upper}
        print(f"{n}: lower {lower!r} upper {upper!r}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"workload": args.workload,
                   "card": torch.cuda.get_device_name(0),
                   "program": program, "control": control,
                   "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
