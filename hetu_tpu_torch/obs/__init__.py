"""Observability of the port (`hetu_tpu/obs` counterparts): the metrics
registry, the run log, the numerics observatory and the health
monitors."""
