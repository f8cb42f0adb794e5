"""HTTP API: aiohttp JSON service with jobs, telemetry, and API-key auth.

Counterpart of ``semcode_tpu/api/``: the same routes, JSON and journal
format, serving the PyTorch engine."""
