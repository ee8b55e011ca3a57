"""Mean lanes (ligands x exhaustiveness) of a dock_batch call: the
screen's batching."""


def read(ctx):
    b = ctx.tracer.batches
    return sum(x["lanes"] for x in b) / len(b) if b else None
