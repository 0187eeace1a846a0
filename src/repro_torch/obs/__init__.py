"""Telemetry of the port: the serving counters and latency histograms
behind `SolveService.snapshot()` (`counters`, its own copy of
`repro.obs.counters`)."""
