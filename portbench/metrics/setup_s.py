"""setup_s: process start to the first timed step (imports, the kernel
build cache, weights and inputs from the seed, warm-up), host clock."""


def read(ctx):
    return ctx.setup_s
