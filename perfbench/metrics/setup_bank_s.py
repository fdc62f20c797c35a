"""setup_bank_s: seconds of set-up in the synthesizer's host bank build and
upload (the numpy Toeplitz ``KB`` of the HRIR mix, or the BRIR spectra): the
sum of the program's ``synth.bank`` spans. Read by ``_recorder.span_s``;
None off the card or without a record."""

from perfbench.metrics._recorder import span_s


def read(ctx):
    return span_s(ctx, "synth.bank")
