"""Telemetry of the port: the serving counters and latency histograms
behind `SolveService.snapshot()` (`counters`, its own copy of
`repro.obs.counters`) and the proc runtime's host-side span tracer
(`trace`, its own copy of `repro.obs.trace`)."""
