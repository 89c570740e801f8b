"""Host milliseconds a call spends in the op wrappers: the self time of the
program's ``gomel.op.<kernel>`` spans (one a launch, from the wrapper's
route to the launch's return, less the host waits inside) over the traced
stretch, divided by the calls submitted in it."""
import sys


def read(ctx):
    prof = sys.modules.get("gomel_tpu_torch.utils.profiling")
    calls = ctx.traced
    if calls is None or not calls.attempted or \
            not hasattr(prof, "recorded"):
        return None
    spans = prof.recorded()["spans"]
    return 1e3 * sum(s["self_s"] for name, s in spans.items()
                     if name.startswith("gomel.op.")) / calls.attempted
