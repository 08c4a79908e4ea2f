"""mean_batch.decode: tokens committed a decode step over the window
(EngineStats.decode_tokens / decode_steps)."""


def read(run):
    steps = run.stats["decode_steps"]
    return run.stats["decode_tokens"] / steps if steps else None
