"""itl_p95_ms: the 95th percentile of every gap between two consecutive
committed tokens of a request, over all requests' gaps in the window."""

from portbench import readers as R


def read(run):
    p = R.percentile(R.window_gaps(run), 95)
    return None if p is None else 1e3 * p
