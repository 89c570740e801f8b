"""Host milliseconds a call spends waiting on the card: the inclusive time
of the program's ``gomel.sync`` spans over the traced stretch, divided by
the calls submitted in it."""
import sys


def read(ctx):
    prof = sys.modules.get("gomel_tpu_torch.utils.profiling")
    calls = ctx.traced
    if calls is None or not calls.attempted or \
            not hasattr(prof, "recorded"):
        return None
    span = prof.recorded()["spans"].get("gomel.sync")
    return 1e3 * (span["total_s"] if span else 0.0) / calls.attempted
