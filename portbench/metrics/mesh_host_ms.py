"""Host milliseconds a call spends in the mesh's scatter and gather and in
the halo pulls, pushes and exchanges: the self time of the program's
``gomel.mesh.*`` and ``gomel.halo.*`` spans over the traced stretch,
divided by the calls submitted in it."""
import sys


def read(ctx):
    prof = sys.modules.get("gomel_tpu_torch.utils.profiling")
    calls = ctx.traced
    if calls is None or not calls.attempted or \
            not hasattr(prof, "recorded"):
        return None
    spans = prof.recorded()["spans"]
    return 1e3 * sum(s["self_s"] for name, s in spans.items()
                     if name.startswith(("gomel.mesh.", "gomel.halo."))
                     ) / calls.attempted
