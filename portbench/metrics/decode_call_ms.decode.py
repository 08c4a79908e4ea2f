"""decode_call_ms.decode: mean wall time of the model's decode_step, from
the harness's span that ends in a synchronize, over the window."""


def read(run):
    spans = run.window_spans("decode")
    if not spans:
        return None
    return 1e3 * sum(s.end - s.start for s in spans) / len(spans)
