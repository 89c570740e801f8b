"""Fast Griffin-Lim iterations a call: the program's
``gl_iterations.momentum`` counter (one an interior iteration with the
momentum step) over the traced stretch, divided by the calls submitted in
it; nothing where the program has no such counter."""
import sys


def read(ctx):
    prof = sys.modules.get("gomel_tpu_torch.utils.profiling")
    calls = ctx.traced
    if calls is None or not calls.attempted or \
            not hasattr(prof, "recorded"):
        return None
    n = prof.recorded()["counters"].get("gl_iterations.momentum")
    return None if n is None else n / calls.attempted
