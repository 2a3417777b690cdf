"""One file a metric of `BENCHMARK.json`, named after it ("." and "-" as
"_"): read(ctx) -> the number, or None where the run has nothing to read
(the harness then leaves the metric out).  `ctx` is `harness.Context`."""
