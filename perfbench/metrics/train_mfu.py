"""train_mfu: the whole step's share of the card's bfloat16 peak, in percent:
6·N·D (``harness.yardstick.train_flops``: N every parameter, D the tokens)
over the traced window's seconds outside the profiled stretches, at 989
TFLOP/s."""

from harness import yardstick


def read(run):
    steps = run.steps - run.profiled_steps
    seconds = run.window_s - run.profiled_s
    if run.profile is None or steps <= 0 or seconds <= 0 or not run.peak_bytes:
        return None
    flops = yardstick.train_flops(run.num_params, steps * run.tokens_per_step)
    return 100.0 * flops / seconds / yardstick.PEAK_BF16
