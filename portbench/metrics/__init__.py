"""Per-layer metric readers: ``metrics/<name>.py`` has ``read(ctx)``, with
``ctx`` a :class:`portbench.harness.Context`, and returns a number, or
None where its cell gives it nothing to read.  :mod:`.roofline` is the
frozen yardstick the ``*_roofline_pct`` readers divide by."""


def is_b5(name: str) -> bool:
    return "b5_" in name


def is_b6(name: str) -> bool:
    return "b6_" in name


def share_pct(cost, seconds: float, peaks) -> float | None:
    """The bound of ``cost`` on ``peaks`` as a percentage of ``seconds``."""
    from . import roofline

    if peaks is None or seconds <= 0:
        return None
    return roofline.bound(cost, peaks)["bound_ms"] / 1e3 / seconds * 100.0


def tail_item(config: dict) -> int:
    return 4 if config.get("tail_dtype") == "bfloat16" else 8
