"""setup_s: seconds from the process's start to the window's start."""


def read(ctx):
    return ctx.get("setup_s")
