"""The harness of the benchmark: cells, spans, traces, counts, answers."""
