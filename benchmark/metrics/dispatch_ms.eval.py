"""Mean host ms of one dispatch call: ``RankingEvaluator.score_slates_async``
(the prefix scorer's packing or the flat scorer's chunking, the H2D
copies and the launches), untraced part of the window."""

from benchmark.harness.readers import span_mean_ms


def read(ctx):
    return span_mean_ms(ctx, "dispatch")
