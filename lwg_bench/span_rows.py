"""Span rows (``lwg_bench/spans.py``'s table) for program spans beyond
``spans.SPANS``: the post-tune's and the all-reduce's, attributed with
``spans.Attribution`` like every other span."""

from __future__ import annotations

from lwg_bench import spans

POSTTUNE = ("posttune", "posttune.pairs", "posttune.step",
            "posttune.refresh")
ALLREDUCE = ("train.allreduce",)


def table(prof, names) -> dict:
    """The span table of a finished profile recorded with host ops, with
    the host ranges named in ``names`` beside those of ``spans.SPANS``."""
    ranges, calls, dev, window = spans.events(prof)
    for e in prof.profiler.kineto_results.events():
        if (e.is_user_annotation() and e.name() in names
                and str(e.device_type()).endswith("CPU")):
            ranges.append((e.name(), e.start_ns(),
                           e.start_ns() + e.duration_ns()))
    return spans.Attribution(ranges, calls, dev, window).table()


def per_count_ms(rows: dict, span: str, per: str):
    """Device ms of ``span`` over the count of ``per``; None where either
    never ran."""
    if span not in rows or not rows.get(per, {}).get("n"):
        return None
    return 1e3 * rows[span]["device_s"] / rows[per]["n"]
