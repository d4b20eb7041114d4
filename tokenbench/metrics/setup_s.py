"""Seconds from the process's start to the window's: imports, the kernel
build where it is not cached yet, the weights, the pools, the cell's
graph buckets and the pre-roll of the open loop."""


def read(ctx):
    return ctx.setup_s
