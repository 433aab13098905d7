"""Engines: how a configuration's program is set up, driven a call at a
time and checked against the reference.  ``engines/<engine>.py`` holds the
class ``Engine`` for configurations whose ``engine`` key names it.

An engine has ``in_flight`` (from the traffic), ``voices``,
``audio_s_per_call`` (seconds of audio a call streams for each voice), and
the methods ``call(index) -> output tensor`` (enqueue one call, inside the
harness's spans), ``free()`` (drop the program and its state) and
``check(kept) -> {name: number}`` (compare the kept outputs, ``{call index:
output}``, with the float64 reference).
"""


def widest(t) -> float:
    """The largest element of a float tensor; infinity if any is not finite
    (a NaN would otherwise compare as no gap at all)."""
    import torch

    return float(t.max()) if bool(torch.isfinite(t).all()) else float("inf")
