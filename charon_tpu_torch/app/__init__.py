"""charon_tpu_torch.app — node assembly.

`run.App` is the node as a process (`python -m charon_tpu_torch run`):
booted from a cluster lock, on the authenticated TCP mesh, talking HTTP
to beacon nodes, with its lifecycle, monitoring API and telemetry.
`node.Node` wires the same core workflow for in-process clusters (a test
or `chip_smoke.py` boots n of them in one process; reference:
app/simnet_test.go:57-197).  The serving layer: VCs reach the node over
HTTP through `router.VapiRouter`, its duty fetches go through
`serving.CachingBeaconClient`, and `otlp` / `log` export its spans and
records, with the SLO-triggered `autoprofile`r beside them.
"""
