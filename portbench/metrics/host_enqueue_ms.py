"""Host milliseconds an entry call takes to return (its work queued, not
done), summed over the window's calls and divided by their number."""


def read(ctx):
    calls = ctx.window.calls
    return 1e3 * sum(c.enqueue_s for c in calls) / len(calls) if calls \
        else None
