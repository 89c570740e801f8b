"""Host milliseconds a call spends in its Griffin-Lim iterations: the
inclusive time of the program's ``gomel.gl.iteration`` spans (one an
iteration, around its projection and overlap-add wrappers) over the traced
stretch, divided by the calls submitted in it; nothing where the program
has no such span."""
import sys


def read(ctx):
    prof = sys.modules.get("gomel_tpu_torch.utils.profiling")
    calls = ctx.traced
    if calls is None or not calls.attempted or \
            not hasattr(prof, "recorded"):
        return None
    span = prof.recorded()["spans"].get("gomel.gl.iteration")
    return None if span is None else 1e3 * span["total_s"] / calls.attempted
