"""Model FLOPs of a training step (three forwards at the configuration's
widths, ``harness/flops.py``) over the window's seconds a step, against the
H100's dense peak of the configuration's compute type."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return 100.0 * ctx["flops_per_unit"] / ctx["step_s"] / ctx["peak_flops"]
