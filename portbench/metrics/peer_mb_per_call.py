"""Megabytes copied between two cards a call (the scatter, the gather, the
halo copies): the program's ``peer_bytes`` counter over the traced stretch
/ 1e6, divided by the calls submitted in it."""
import sys


def read(ctx):
    prof = sys.modules.get("gomel_tpu_torch.utils.profiling")
    calls = ctx.traced
    if calls is None or not calls.attempted or \
            not hasattr(prof, "recorded"):
        return None
    return prof.recorded()["counters"].get("peer_bytes", 0) / 1e6 \
        / calls.attempted
