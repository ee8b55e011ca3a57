"""Set-up: the harness's first line to the window's start (imports, the
inputs, the warm-up calls that build or load the libraries and models)."""


def read(ctx):
    return ctx.setup_s
