"""Ligands docked per second: ligands with a written pose, over the time
from the window's start to the return of its last call."""


def read(ctx):
    return (ctx.attempted - ctx.failed) / ctx.window_s
