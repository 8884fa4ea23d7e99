"""Share of the graph cache's calls in the window that replayed a kept
graph (``vittf_tpu_torch.utils.cuda_graphs.GRAPHS``: hits over hits,
captures and eager first sightings)."""


def read(ctx):
    c = ctx.counters
    calls = c.get("graph_hits", 0) + c.get("graph_misses", 0) + c.get("graph_eager", 0)
    if not calls:
        return None
    return 100.0 * c["graph_hits"] / calls
