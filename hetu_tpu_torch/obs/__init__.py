"""Observability of the port (`hetu_tpu/obs` counterparts): the metrics
registry, the run log, the numerics observatory, the health monitors,
and the serving traces' spans, critical paths and chrome-trace
renders."""
