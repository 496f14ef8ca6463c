"""train_tokens_per_s: the tokens of every step of the window over the
window's seconds, to its final synchronize (host clock)."""


def read(run):
    return run.steps * run.tokens_per_step / run.window_s
