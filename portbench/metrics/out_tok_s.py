"""out_tok_s: every token committed in the window over the window's
seconds (host clock; the chat cells)."""

from portbench import readers as R


def read(run):
    return len(R.window_tokens(run)) / (run.t1 - run.t0)
