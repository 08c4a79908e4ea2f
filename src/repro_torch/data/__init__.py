from repro_torch.data.pipeline import (  # noqa: F401
    ClassifyDataConfig,
    LMDataConfig,
    TokenFileSource,
    minibatches,
    synthetic_classification,
    synthetic_lm_batch,
    synthetic_lm_stream,
)
