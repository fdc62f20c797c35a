"""train_step_mfu: percent of the card's dense bfloat16 peak that the
traced window's utterances per second reach at the step's FLOPs per
utterance (the products of the reference model's forward and backward,
``bounds.train_flops_per_utt``). None for a card not in the peak table."""

from perfbench import bounds


def read(ctx):
    rate = bounds.peak(ctx.get("device_kind"), "bf16_flops")
    if ctx.get("kind") != "train" or rate is None or "flops_per_utt" not in ctx:
        return None
    return 100.0 * ctx["flops_per_utt"] * ctx["traced_utt_s"] / rate
