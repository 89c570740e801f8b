"""Host waits on the card a call: the program's ``host_syncs.<kind>``
counters (one a ``gomel.sync`` span: a blocking upload, a read back, a
synchronise, a halo exchange's wait) summed over the kinds, over the traced
stretch, divided by the calls submitted in it."""
import sys


def read(ctx):
    prof = sys.modules.get("gomel_tpu_torch.utils.profiling")
    calls = ctx.traced
    if calls is None or not calls.attempted or \
            not hasattr(prof, "recorded"):
        return None
    counters = prof.recorded()["counters"]
    return sum(v for k, v in counters.items()
               if k.startswith("host_syncs.")) / calls.attempted
