"""build_s: the wall time of the program's index build in set-up
(``build_index``, from the graph to the forest on the card)."""


def read(ctx):
    return ctx.get("build_s")
