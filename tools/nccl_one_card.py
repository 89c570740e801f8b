"""What NCCL does with two ranks on one card.

    python3 tools/nccl_one_card.py

Starts two processes that each join one NCCL group on cuda:0 (bypassing
gomel_tpu_torch's mesh, which refuses that layout) and run one all-reduce
of a card tensor, each bounded by a 60 s time limit, and prints each
process's exit code and the last lines of its output: the error text NCCL
gives. Prints the card's name and power limit first. Exits 0 when both
processes have ended (whatever they reported), 1 when one had to be killed.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist


def worker(rank: int, port: int) -> int:
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=30))
    try:
        t = torch.ones(4, device="cuda:0") * (rank + 1)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        print(f"rank {rank}: all_reduce gave {t.tolist()}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, NCCL_DEBUG="WARN")
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               str(port)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    killed = False
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=60)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0]
            killed = True
        lines = [ln for ln in out.splitlines() if ln.strip()]
        print(f"--- rank {r}: exit code {p.returncode}", flush=True)
        print("\n".join(lines[-12:]), flush=True)
    return 1 if killed else 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        sys.exit(worker(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
