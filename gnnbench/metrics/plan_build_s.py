"""plan_build_s (graph layer): host seconds of the graph's plans in this
run, from the program's `Graph.build_stats`: the cache's load where the
graph came from the cache, else the build."""


def read(ctx, part):
    return ctx.plan_s
