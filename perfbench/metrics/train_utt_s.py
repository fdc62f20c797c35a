"""train_utt_s: utterances trained in the window over the window's
seconds (whole chunks, the window ending in a synchronise)."""


def read(ctx):
    w = ctx.get("window")
    if ctx.get("kind") != "train" or not w:
        return None
    return w["utt"] / w["wall_s"]
